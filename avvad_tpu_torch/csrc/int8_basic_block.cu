// Fused static-int8 ResNet BasicBlock for Hopper (sm_90a): one launch per block,
// products on wgmma with the weights staged through shared memory.
//
// Replaces avvad_tpu/ops/conv_pallas.py `_block_kernel`, called through
// `basic_block_int8` (conv_pallas.py:155). Per output pixel and channel:
//   y1  = q(relu(acc1 * a1 + b1))                 acc1 = 3x3/stride conv of x (int32)
//   y2  = acc2 * a2 + b2                          acc2 = 3x3/1 conv of y1
//   res = x * res_scale              (identity)   or accd * ad + bd (1x1/stride conv)
//   out = q(relu(y2 + res)),   q(v) = min(rint(v), 127)  (v >= 0 after relu)
// The a*/b* vectors are the folded BatchNorm and requantisation affines
// (ops/conv_fused.py fold_block). Activations are NHWC int8, channels innermost.
//
// Numerics: the int8 x int8 -> int32 sums are exact in any order; the epilogue
// converts with __int2float_rn and uses __fmul_rn / __fadd_rn (no FMA
// contraction) and rintf (half to even, like jnp.round / torch.round), so the
// kernel is bit-identical to its plain PyTorch version (float64 conv -> float
// -> acc * a + b).
//
// What bounds it on an H100: at the serving shape (15,744 frames) the trunk's
// 8 blocks do 213 M MAC per frame, 6.7 TOP in all: 3.4 ms at the 1,979 TOP/s
// int8 tensor-core peak against 0.8 ms for the int8 activations' bytes, so it is
// bound by operations. The weights (11 MB int8 in all) sit in the 50 MB L2, but
// every CTA reads a block's whole weight once per `pass` of its output rows:
// at the tensor cores' peak an SM eats 4096 MAC a clock, so a pass of M rows
// pulls 4096 / M weight bytes a clock and SM through L2. The design is about
// keeping that small and hidden.
//
// Design (ops/conv_fused.py block_plan picks the numbers):
//  - A CTA takes F whole frames, its output pixels M = F * Ho * Wo filling
//    m64 tiles (about 250 rows where the shared memory allows). It copies the
//    frames' input into shared memory once, runs conv1 as an implicit GEMM
//    whose requantised int8 output y1 stays in shared memory, then conv2 (and
//    the 1x1 downsample) over shared memory, and writes only the int8 output.
//  - 384 threads: two consumer warpgroups and a producer warpgroup of which
//    one thread works; setmaxnreg hands its registers to the consumers (40
//    against 232 a thread). The weights are packed on the host (pack_tiles)
//    into chunks of NTILE output channels x 128 k, each chunk the exact
//    shared-memory image wgmma wants (K-major rows of 128 bytes, 128-byte
//    swizzle), so a chunk is one cp.async.bulk of 4, 8 or 16 KB onto an
//    mbarrier. The producer keeps a ring
//    of 2-4 chunks in flight ("full" barriers); the consumers release a slot
//    when the wgmmas that read it have retired ("empty" barriers).
//  - The products are wgmma.mma_async m64nNk32 s8 x s8 -> s32, N = 128, 64 or
//    32 (the largest that divides Cout),
//    B from the ring by descriptor, A from registers: the implicit-GEMM
//    gather (output pixel, tap) with zeros for padding is no regular
//    shared-memory matrix, so each thread gathers its fragment rows with
//    32-bit shared loads, offsets computed once per tap, one k step ahead of
//    the wgmma that eats them (two register buffers, wait_group 1).
//  - A pass is 2 warpgroups x MT m64 tiles against every weight chunk of the
//    conv: MT = 2 for identity blocks (256 rows a pass), 1 for downsample
//    blocks, whose 1x1 sums need a second accumulator set until the epilogue.
//  - Shared pixel rows are padded by 16 bytes so that the 8 rows of a
//    fragment fall in different banks.
// Where it stands: 2-5x its bound, block by block. Layer3's and layer4's
// blocks take 125-250 rows a CTA (the x and y1 tiles of more frames do not
// fit beside the ring) and sit on the L2 reads of their weights; the 64- and
// 128-channel blocks spend their time in the k loop, where a wgmma with A
// from registers retires before the next one of its chain starts, and in the
// epilogue's 2-byte stores, with both warpgroups in step on the shared ring.
// Not taken yet: a 2-CTA cluster with a multicast copy of each chunk, a
// persistent grid that loads the next x tile under conv2, wider stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCONS = 256;            // consumer threads: two warpgroups
constexpr int NTHREADS = NCONS + 128;  // and the producer's warpgroup
constexpr int PAD = 16;               // bytes of padding per pixel row in shared memory
constexpr int KCHUNK = 128;           // k per weight chunk: one swizzled row
constexpr int MAX_STAGES = 4;         // ring slots at most
constexpr int ALIGN = 1024;           // the swizzle pattern repeats every 1024 bytes

struct Params {
  const int8_t* x;
  const int8_t* w1;  // tile-major chunks, see pack_tiles
  const float* a1;
  const float* b1;
  const int8_t* w2;
  const float* a2;
  const float* b2;
  const int8_t* wd;
  const float* ad;
  const float* bd;
  const float* res_scale;
  int8_t* out;
  int N, H, W, Cin, Cout, stride, F, stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!ok);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// one contiguous chunk, global -> shared, completion counted on `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte rows and
// the 128-byte swizzle: start address, leading offset 16 B (unused by this
// layout), 1024 B between groups of 8 rows.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d (64 x N int32, this thread's N / 2 values) (+)= a (64 x 32 int8 fragment
// in registers) . b (32 x N by descriptor); scale_d == 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<32>(int (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, {%16,%17,%18,%19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31}, {%32,%33,%34,%35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,"
      "%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
      "{%64,%65,%66,%67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// relu -> round half to even -> clip to 127
__device__ __forceinline__ int8_t requant(float v) {
  return (int8_t)fminf(rintf(fmaxf(v, 0.0f)), 127.0f);
}

__device__ __forceinline__ float affine(int acc, float a, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
}

// A conv source in shared memory: frames of Hs x Ws pixels, `ps` bytes per
// pixel row, C channels; output pixel (ho, wo) reads source pixel
// (ho * s - pad + dy, wo * s - pad + dx) for each of the `taps` taps (9 or 1).
struct Src {
  const int8_t* base;
  int Hs, Ws, C, ps, s, pad, taps;
};

// The weight ring as a consumer or the producer walks it: chunk `i` of the
// CTA's sequence lives in slot i % stages, in phase (i / stages) & 1.
struct Ring {
  uint32_t data, full, empty;  // shared addresses: slots, barriers
  uint32_t chunk_bytes;
  int stages, slot;
  uint32_t phase;
  __device__ __forceinline__ void advance() {
    if (++slot == stages) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// acc[i] (+)= rows of m64 tile `tile(i)` x the NTILE columns of n tile `nt`
// of the implicit GEMM of `src` with the conv's packed weight, whose chunks
// for this n tile are the next ceil(K / 128) of the ring. tile(i) =
// tile0 + 2 i for i < mt_active; a warpgroup with no tile still walks the
// ring, so that every consumer warp releases every slot.
template <int NTILE, int MT>
__device__ __forceinline__ void gemm_pass(int (&acc)[MT][NTILE / 2], const Src src, Ring& ring,
                                          int tile0, int mt_active, int m_valid, int P, int Wo,
                                          int wq) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int K32 = src.taps * src.C / 32;  // k steps of 32
  const int kchunks = (K32 + 3) / 4;
  const int kw = src.taps == 9 ? 3 : 1;
  int fbase[MT][2], hw0[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (tile0 + 2 * i) * 64 + wq * 16 + g + 8 * h;
      if (i < mt_active && r < m_valid) {
        const int f = r / P, p = r - f * P, ho = p / Wo, wo = p - ho * Wo;
        fbase[i][h] = f * src.Hs * src.Ws;
        hw0[i][h] = ((ho * src.s - src.pad) << 16) | ((wo * src.s - src.pad) & 0xffff);
      } else {
        fbase[i][h] = 0;
        hw0[i][h] = (int)0x80000000;  // hi far below 0: never in bounds
      }
    }
  int off[MT][2];
  int tap = -1, next_tap = 0, cb = 0;  // the k step to gather next: (next_tap, cb)
  uint32_t a[2][MT][4];

  auto gather = [&](uint32_t (&dst)[MT][4]) {
    if (next_tap != tap) {
      tap = next_tap;
      const int dy = tap / kw, dx = tap - dy * kw;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int hi = (hw0[i][h] >> 16) + dy, wi = (int)(short)(hw0[i][h] & 0xffff) + dx;
          off[i][h] = (hi >= 0 && hi < src.Hs && wi >= 0 && wi < src.Ws)
                          ? (fbase[i][h] + hi * src.Ws + wi) * src.ps + tig * 4
                          : -1;
        }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if (i < mt_active) {
        const int8_t* p0 = src.base + off[i][0] + cb;
        const int8_t* p1 = src.base + off[i][1] + cb;
        dst[i][0] = off[i][0] >= 0 ? *reinterpret_cast<const uint32_t*>(p0) : 0u;
        dst[i][1] = off[i][1] >= 0 ? *reinterpret_cast<const uint32_t*>(p1) : 0u;
        dst[i][2] = off[i][0] >= 0 ? *reinterpret_cast<const uint32_t*>(p0 + 16) : 0u;
        dst[i][3] = off[i][1] >= 0 ? *reinterpret_cast<const uint32_t*>(p1 + 16) : 0u;
      }
    }
    cb += 32;
    if (cb == src.C) {
      cb = 0;
      ++next_tap;
    }
  };

  gather(a[0]);
  uint32_t prev_empty = 0;
  for (int kc = 0; kc < kchunks; ++kc) {
    mbar_wait(ring.full + 8 * ring.slot, ring.phase);
    const uint64_t desc = b_desc(ring.data + ring.slot * ring.chunk_bytes);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ks = kc * 4 + q;
      if (ks < K32) {
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (i < mt_active) wgmma_s8<NTILE>(acc[i], a[q & 1][i], desc + 2 * q, ks > 0);
        wgmma_commit();
        wgmma_wait<1>();  // step ks - 1 has retired: its fragment buffer is free
        if (q == 0 && kc > 0 && lane == 0) mbar_arrive(prev_empty);  // and the chunk before
        if (ks + 1 < K32) gather(a[(q + 1) & 1]);
      }
    }
    prev_empty = ring.empty + 8 * ring.slot;
    ring.advance();
  }
  wgmma_wait<0>();
  if (lane == 0) mbar_arrive(prev_empty);
}

template <int NTILE, int MT, bool DOWN>
__global__ void __launch_bounds__(NTHREADS, 1) int8_basic_block_kernel(const Params p) {
  extern __shared__ uint8_t smem_raw[];
  // the warp index by shuffle, so that the compiler sees the role split and
  // the tile counts as warp-uniform and keeps the wgmmas asynchronous
  const int lane = threadIdx.x & 31, warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int Ho = (p.H - 1) / p.stride + 1, Wo = (p.W - 1) / p.stride + 1;
  const int HW = p.H * p.W, P = Ho * Wo;
  const int xs = p.Cin + PAD, ys = p.Cout + PAD;
  constexpr uint32_t CB = NTILE * KCHUNK;  // bytes of a weight chunk
  // ring | x tile | y1 tile | barriers, the ring on a 1024-byte boundary
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + ((ALIGN - (raw & (ALIGN - 1))) & (ALIGN - 1));
  int8_t* xsm = reinterpret_cast<int8_t*>(base + (size_t)p.stages * CB);
  int8_t* ysm = xsm + (size_t)p.F * HW * xs;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ysm + (size_t)p.F * P * ys);
  const int f0 = blockIdx.x * p.F;
  const int nf = min(p.F, p.N - f0);
  const int m_valid = nf * P;
  const int ntiles = (m_valid + 63) / 64;
  const int npass = (ntiles + 2 * MT - 1) / (2 * MT);
  const int NT = p.Cout / NTILE;
  const int kc1 = (9 * p.Cin + KCHUNK - 1) / KCHUNK, kc2 = (9 * p.Cout + KCHUNK - 1) / KCHUNK;
  const int kcd = (p.Cin + KCHUNK - 1) / KCHUNK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(bars + s), 1);                          // full: the producer
      mbar_init(smem_u32(bars + MAX_STAGES + s), NCONS / 32);    // empty: consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the CTA's frames -> shared memory, 16 bytes at a time
  {
    const int vpp = p.Cin / 16;  // 16-byte vectors per pixel
    const uint4* src = reinterpret_cast<const uint4*>(p.x + (size_t)f0 * HW * p.Cin);
    for (int i = threadIdx.x; i < nf * HW * vpp; i += NTHREADS) {
      const int px = i / vpp, v = i - px * vpp;
      *reinterpret_cast<uint4*>(xsm + (size_t)px * xs + v * 16) = __ldg(src + i);
    }
  }
  __syncthreads();

  Ring ring{smem_u32(base), smem_u32(bars), smem_u32(bars + MAX_STAGES), CB, p.stages, 0, 0};

  if (warp >= NCONS / 32) {
    // producer: the chunks in the order the consumers eat them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == NCONS / 32 && lane == 0) {
      ring.phase = 1;  // a fresh slot is empty
      auto push = [&](const int8_t* w, int first, int n) {
        const int8_t* src = w + (size_t)first * CB;
        for (int c = 0; c < n; ++c, src += CB) {
          mbar_wait(ring.empty + 8 * ring.slot, ring.phase);
          mbar_expect_tx(ring.full + 8 * ring.slot, CB);
          bulk_g2s(ring.data + ring.slot * CB, src, CB, ring.full + 8 * ring.slot);
          ring.advance();
        }
      };
      for (int pass = 0; pass < npass; ++pass) push(p.w1, 0, NT * kc1);
      for (int pass = 0; pass < npass; ++pass)
        for (int nt = 0; nt < NT; ++nt) {
          if (DOWN) push(p.wd, nt * kcd, kcd);
          push(p.w2, nt * kc2, kc2);
        }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  int acc[MT][NTILE / 2];

  // conv1 -> folded BN, ReLU, requant -> y1 in shared memory
  const Src s1{xsm, p.H, p.W, p.Cin, xs, p.stride, 1, 9};
  for (int pass = 0; pass < npass; ++pass) {
    const int tile0 = pass * 2 * MT + wg;
    const int mt_active = max(0, min(MT, (ntiles - tile0 + 1) / 2));
    for (int nt = 0; nt < NT; ++nt) {
      gemm_pass<NTILE, MT>(acc, s1, ring, tile0, mt_active, m_valid, P, Wo, wq);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt_active) break;
        const int r0 = (tile0 + 2 * i) * 64 + wq * 16 + g;
#pragma unroll
        for (int j = 0; j < NTILE / 8; ++j) {
          const int c = nt * NTILE + j * 8 + tig * 2;
          const float2 av = __ldg(reinterpret_cast<const float2*>(p.a1 + c));
          const float2 bv = __ldg(reinterpret_cast<const float2*>(p.b1 + c));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r < m_valid)
              *reinterpret_cast<char2*>(ysm + (size_t)r * ys + c) =
                  make_char2(requant(affine(acc[i][4 * j + 2 * h], av.x, bv.x)),
                             requant(affine(acc[i][4 * j + 2 * h + 1], av.y, bv.y)));
          }
        }
      }
    }
  }
  // y1 complete on every consumer warp before conv2 reads it
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS) : "memory");

  // conv2 -> folded BN, + residual, ReLU, requant -> out
  const Src s2{ysm, Ho, Wo, p.Cout, ys, 1, 1, 9};
  const Src sd{xsm, p.H, p.W, p.Cin, xs, p.stride, 0, 1};
  const float rs = DOWN ? 0.0f : __ldg(p.res_scale);
  int accd[DOWN ? MT : 1][NTILE / 2];
  for (int pass = 0; pass < npass; ++pass) {
    const int tile0 = pass * 2 * MT + wg;
    const int mt_active = max(0, min(MT, (ntiles - tile0 + 1) / 2));
    for (int nt = 0; nt < NT; ++nt) {
      if constexpr (DOWN)
        gemm_pass<NTILE, MT>(accd, sd, ring, tile0, mt_active, m_valid, P, Wo, wq);
      gemm_pass<NTILE, MT>(acc, s2, ring, tile0, mt_active, m_valid, P, Wo, wq);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt_active) break;
        const int r0 = (tile0 + 2 * i) * 64 + wq * 16 + g;
#pragma unroll
        for (int j = 0; j < NTILE / 8; ++j) {
          const int c = nt * NTILE + j * 8 + tig * 2;
          const float2 av = __ldg(reinterpret_cast<const float2*>(p.a2 + c));
          const float2 bv = __ldg(reinterpret_cast<const float2*>(p.b2 + c));
          float2 adv = make_float2(0.0f, 0.0f), bdv = adv;
          if constexpr (DOWN) {
            adv = __ldg(reinterpret_cast<const float2*>(p.ad + c));
            bdv = __ldg(reinterpret_cast<const float2*>(p.bd + c));
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r >= m_valid) continue;
            const float y0 = affine(acc[i][4 * j + 2 * h], av.x, bv.x);
            const float y1 = affine(acc[i][4 * j + 2 * h + 1], av.y, bv.y);
            float r0v, r1v;
            if constexpr (DOWN) {
              r0v = affine(accd[i][4 * j + 2 * h], adv.x, bdv.x);
              r1v = affine(accd[i][4 * j + 2 * h + 1], adv.y, bdv.y);
            } else {  // identity: stride 1, so row r is pixel r of the x tile
              const char2 xv = *reinterpret_cast<const char2*>(xsm + (size_t)r * xs + c);
              r0v = __fmul_rn((float)xv.x, rs);
              r1v = __fmul_rn((float)xv.y, rs);
            }
            *reinterpret_cast<char2*>(p.out + ((size_t)f0 * P + r) * p.Cout + c) =
                make_char2(requant(__fadd_rn(y0, r0v)), requant(__fadd_rn(y1, r1v)));
          }
        }
      }
    }
  }
}

// Shared memory of a CTA: alignment slack, the ring, the x and y1 tiles of F
// frames, the barriers.
size_t smem_bytes(int ntile, int stages, int F, int H, int W, int Cin, int Cout, int stride) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  return (size_t)ALIGN + (size_t)stages * ntile * KCHUNK +
         (size_t)F * ((size_t)H * W * (Cin + PAD) + (size_t)Ho * Wo * (Cout + PAD)) +
         2 * MAX_STAGES * 8;
}

template <int NTILE, int MT, bool DOWN>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(int8_basic_block_kernel<NTILE, MT, DOWN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (p.N + p.F - 1) / p.F;
  int8_basic_block_kernel<NTILE, MT, DOWN><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin) int8; w1, w2, wd: the (Cout, 9 Cin), (Cout, 9 Cout),
// (Cout, Cin) int8 weights with k = (dy * 3 + dx) * C + c, packed by
// ops/conv_fused.py pack_tiles into chunks of NTILE output channels x 128 k
// (NTILE = 128, 64 or 32, the largest that divides Cout; k zero-padded to a
// multiple of 128); a*/b* (Cout,) f32; out (N, Ho, Wo, Cout) int8. wd == NULL selects the
// identity residual (Cin == Cout, stride 1) scaled by *res_scale, one f32 in
// device memory (no host read of the scale). F: frames per CTA, stages: ring
// slots, smem: the plan's shared-memory bytes, which must equal this file's
// count. Returns the launch's cudaError_t (0 on success).
extern "C" int int8_basic_block(const void* x, const void* w1, const void* a1, const void* b1,
                                const void* w2, const void* a2, const void* b2,
                                const void* wd, const void* ad, const void* bd,
                                const void* res_scale, void* out, int N, int H, int W, int Cin,
                                int Cout, int stride, int F, int stages, int smem,
                                void* stream) {
  if (N <= 0) return 0;
  if (Cin % 32 || Cout % 32 || F < 1 || stages < 2 || stages > MAX_STAGES ||
      (stride != 1 && stride != 2) || H >= 32768 || W >= 32768 ||
      (wd == nullptr && (Cin != Cout || stride != 1 || res_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int ntile = Cout % 128 == 0 ? 128 : Cout % 64 == 0 ? 64 : 32;
  const size_t need = smem_bytes(ntile, stages, F, H, W, Cin, Cout, stride);
  if (need != (size_t)smem) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const int8_t*>(x),  static_cast<const int8_t*>(w1),
                 static_cast<const float*>(a1),  static_cast<const float*>(b1),
                 static_cast<const int8_t*>(w2), static_cast<const float*>(a2),
                 static_cast<const float*>(b2),  static_cast<const int8_t*>(wd),
                 static_cast<const float*>(ad),  static_cast<const float*>(bd),
                 static_cast<const float*>(res_scale), static_cast<int8_t*>(out),
                 N, H, W, Cin, Cout, stride, F, stages};
  const auto st = static_cast<cudaStream_t>(stream);
  if (wd != nullptr)
    return ntile == 128  ? launch<128, 1, true>(p, need, st)
           : ntile == 64 ? launch<64, 1, true>(p, need, st)
                         : launch<32, 1, true>(p, need, st);
  return ntile == 128  ? launch<128, 2, false>(p, need, st)
         : ntile == 64 ? launch<64, 2, false>(p, need, st)
                       : launch<32, 2, false>(p, need, st);
}
