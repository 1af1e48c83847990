// Fused static-int8 ResNet BasicBlock for Hopper (sm_90a): one launch per block.
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
// Numerics: the int8 x int8 -> int32 sums are exact; the epilogue converts with
// __int2float_rn and uses __fmul_rn / __fadd_rn (no FMA contraction) and rintf
// (half to even, like jnp.round / torch.round), so the kernel is bit-identical
// to its plain PyTorch version (float64 conv -> float -> acc * a + b).
//
// What bounds it on an H100: at the serving shape (15,744 frames) the trunk's
// 8 blocks do 213 M MAC per frame, 6.7 TOP in all: 3.4 ms at the 1,979 TOP/s
// int8 tensor-core peak against 0.8 ms for the int8 activations' bytes, so it is
// bound by operations. The weights (11 MB int8 in all) sit in the 50 MB L2.
//
// Design: a CTA takes F whole frames (F chosen by the wrapper so that the
// CTA's output pixels M = F * Ho * Wo are about 128-600 rows). It copies the
// frames' input into shared memory once (16-byte loads; the frames are
// contiguous in NHWC), runs conv1 as an implicit GEMM whose requantised int8
// output y1 stays in shared memory, then conv2 (and the 1x1 downsample) over
// shared memory, and writes only the int8 output: no int32 or float tensor
// reaches device memory. Products are mma.sync m16n8k32 s8*s8->s32 on the
// tensor cores. Each warp item is 64 output pixels (4 m16 tiles) x 32 output
// channels (4 n8 tiles); A fragments are 32-bit shared loads gathered per
// output pixel and tap (zero for padding), B fragments 32-bit loads of the
// packed (Cout, taps*Cin) weight straight from L2, shared by the item's 4 m
// tiles. Shared pixel rows are padded by 16 bytes so the 8 rows of a fragment
// fall in different banks. wgmma, TMA and weight staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARP = 8;   // warps per CTA
constexpr int MT = 4;      // m16 tiles per warp item (64 output pixels)
constexpr int NT = 4;      // n8 tiles per warp item (32 output channels)
constexpr int PAD = 16;    // bytes of padding per pixel row in shared memory

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// relu -> round half to even -> clip to 127
__device__ __forceinline__ int8_t requant(float v) {
  return (int8_t)fminf(rintf(fmaxf(v, 0.0f)), 127.0f);
}

__device__ __forceinline__ float affine(int acc, float a, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), a), b);
}

// A conv source in shared memory: F frames of Hs x Ws pixels, `ps` bytes per
// pixel row, C channels; output pixel (ho, wo) reads source pixel
// (ho * s - pad + dy, wo * s - pad + dx) for each of the `taps` taps (9 or 1).
struct Src {
  const int8_t* base;
  int Hs, Ws, C, ps, s, pad, taps;
};

// acc[mt][nt] += rows [m0, m0 + 64) x cols [n0, n0 + 32) of the implicit GEMM
// of `src` with the packed weight w (Cout, taps * C), k = tap * C + c.
__device__ __forceinline__ void conv_pass(int (&acc)[MT][NT][4], const Src src,
                                          const int8_t* __restrict__ w, int m0, int n0,
                                          int m_valid, int P, int Wo, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int K = src.taps * src.C;
  int fbase[MT][2], hi0[MT][2], wi0[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mt * 16 + g + 8 * h;
      if (r < m_valid) {
        const int f = r / P, p = r - f * P, ho = p / Wo, wo = p - ho * Wo;
        fbase[mt][h] = f * src.Hs * src.Ws;
        hi0[mt][h] = ho * src.s - src.pad;
        wi0[mt][h] = wo * src.s - src.pad;
      } else {
        fbase[mt][h] = 0;
        hi0[mt][h] = -(1 << 20);  // never in bounds
        wi0[mt][h] = 0;
      }
    }
  const int kw = src.taps == 9 ? 3 : 1;
  for (int tap = 0; tap < src.taps; ++tap) {
    const int dy = tap / kw, dx = tap - dy * kw;
    int off[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int hi = hi0[mt][h] + dy, wi = wi0[mt][h] + dx;
        off[mt][h] = (hi >= 0 && hi < src.Hs && wi >= 0 && wi < src.Ws)
                         ? (fbase[mt][h] + hi * src.Ws + wi) * src.ps + tig * 4
                         : -1;
      }
    const int8_t* wt = w + (long long)(n0 + g) * K + tap * src.C + tig * 4;
    for (int cb = 0; cb < src.C; cb += 32) {
      int b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int* wp = reinterpret_cast<const int*>(wt + (long long)nt * 8 * K + cb);
        b[nt][0] = __ldg(wp);
        b[nt][1] = __ldg(wp + 4);  // k + 16
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (m0 + mt * 16 >= m_valid) break;  // warp-uniform
        int a[4];
        a[0] = off[mt][0] >= 0 ? *reinterpret_cast<const int*>(src.base + off[mt][0] + cb) : 0;
        a[1] = off[mt][1] >= 0 ? *reinterpret_cast<const int*>(src.base + off[mt][1] + cb) : 0;
        a[2] = off[mt][0] >= 0 ? *reinterpret_cast<const int*>(src.base + off[mt][0] + cb + 16) : 0;
        a[3] = off[mt][1] >= 0 ? *reinterpret_cast<const int*>(src.base + off[mt][1] + cb + 16) : 0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_s8(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
}

__device__ __forceinline__ void zero(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
}

template <bool DOWN>
__global__ void __launch_bounds__(NWARP * 32)
int8_basic_block_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w1,
                        const float* __restrict__ a1, const float* __restrict__ b1,
                        const int8_t* __restrict__ w2, const float* __restrict__ a2,
                        const float* __restrict__ b2, const int8_t* __restrict__ wd,
                        const float* __restrict__ ad, const float* __restrict__ bd,
                        const float* __restrict__ res_scale, int8_t* __restrict__ out, int N,
                        int H, int W, int Cin, int Cout, int stride, int F) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const int HW = H * W, P = Ho * Wo;
  const int xs = Cin + PAD, ys = Cout + PAD;
  int8_t* xsm = smem;
  int8_t* ysm = smem + (size_t)F * HW * xs;
  const int f0 = blockIdx.x * F;
  const int nf = min(F, N - f0);
  const int m_valid = nf * P;

  // 1. the CTA's frames -> shared memory, 16 bytes at a time
  {
    const int vpp = Cin / 16;  // 16-byte vectors per pixel
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)f0 * HW * Cin);
    for (int i = threadIdx.x; i < nf * HW * vpp; i += blockDim.x) {
      const int px = i / vpp, v = i - px * vpp;
      *reinterpret_cast<uint4*>(xsm + (size_t)px * xs + v * 16) = __ldg(src + i);
    }
  }
  __syncthreads();

  const int mtiles = (m_valid + 15) / 16;
  const int groups = (mtiles + MT - 1) / MT;
  const int items = groups * (Cout / (8 * NT));
  int acc[MT][NT][4];

  // 2. conv1 -> folded BN, ReLU, requant -> y1 in shared memory
  const Src s1{xsm, H, W, Cin, xs, stride, 1, 9};
  for (int it = warp; it < items; it += NWARP) {
    const int m0 = (it % groups) * MT * 16, n0 = (it / groups) * 8 * NT;
    zero(acc);
    conv_pass(acc, s1, w1, m0, n0, m_valid, P, Wo, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = m0 + mt * 16 + g + (i >= 2 ? 8 : 0);
          const int c = n0 + nt * 8 + tig * 2 + (i & 1);
          if (r < m_valid) ysm[(size_t)r * ys + c] = requant(affine(acc[mt][nt][i], a1[c], b1[c]));
        }
  }
  __syncthreads();

  // 3. conv2 -> folded BN, + residual, ReLU, requant -> out
  const Src s2{ysm, Ho, Wo, Cout, ys, 1, 1, 9};
  const float rs = DOWN ? 0.0f : __ldg(res_scale);
  const Src sd{xsm, H, W, Cin, xs, stride, 0, 1};
  for (int it = warp; it < items; it += NWARP) {
    const int m0 = (it % groups) * MT * 16, n0 = (it / groups) * 8 * NT;
    float res[MT][NT][4];
    if (DOWN) {
      zero(acc);
      conv_pass(acc, sd, wd, m0, n0, m_valid, P, Wo, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = n0 + nt * 8 + tig * 2 + (i & 1);
            res[mt][nt][i] = affine(acc[mt][nt][i], ad[c], bd[c]);
          }
    }
    zero(acc);
    conv_pass(acc, s2, w2, m0, n0, m_valid, P, Wo, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m0 + mt * 16 + g + 8 * h;
          if (r >= m_valid) continue;
          const int c = n0 + nt * 8 + tig * 2;
          int8_t q[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * h + e;
            const float y2 = affine(acc[mt][nt][i], a2[c + e], b2[c + e]);
            float rv;
            if (DOWN) {
              rv = res[mt][nt][i];
            } else {  // identity: same pixel of x, same channel (Cin == Cout)
              const int f = r / P, p = r - f * P;
              rv = __fmul_rn((float)xsm[(size_t)(f * HW + p) * xs + c + e], rs);
            }
            q[e] = requant(__fadd_rn(y2, rv));
          }
          *reinterpret_cast<char2*>(out + ((size_t)f0 * P + r) * Cout + c) = make_char2(q[0], q[1]);
        }
  }
}

template <bool DOWN>
int launch(const int8_t* x, const int8_t* w1, const float* a1, const float* b1,
           const int8_t* w2, const float* a2, const float* b2, const int8_t* wd,
           const float* ad, const float* bd, const float* res_scale, int8_t* out, int N, int H,
           int W, int Cin, int Cout, int stride, int F, cudaStream_t stream) {
  const int Ho = (H - 1) / stride + 1, Wo = (W - 1) / stride + 1;
  const size_t smem = (size_t)F * ((size_t)H * W * (Cin + PAD) + (size_t)Ho * Wo * (Cout + PAD));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_basic_block_kernel<DOWN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (N + F - 1) / F;
  int8_basic_block_kernel<DOWN><<<grid, NWARP * 32, smem, stream>>>(
      x, w1, a1, b1, w2, a2, b2, wd, ad, bd, res_scale, out, N, H, W, Cin, Cout, stride, F);
  return (int)cudaGetLastError();
}

}  // namespace

// x (N, H, W, Cin) int8; w1 (Cout, 9 Cin), w2 (Cout, 9 Cout), wd (Cout, Cin) int8
// with k = (dy * 3 + dx) * C + c; a*/b* (Cout,) f32; out (N, Ho, Wo, Cout) int8.
// wd == NULL selects the identity residual (Cin == Cout, stride 1) scaled by
// *res_scale, one f32 in device memory (no host read of the scale). F: frames
// per CTA. Returns the launch's cudaError_t (0 on success).
extern "C" int int8_basic_block(const void* x, const void* w1, const void* a1, const void* b1,
                                const void* w2, const void* a2, const void* b2,
                                const void* wd, const void* ad, const void* bd,
                                const void* res_scale, void* out, int N, int H, int W, int Cin,
                                int Cout, int stride, int F, void* stream) {
  if (N <= 0) return 0;
  if (Cin % 32 || Cout % 32 || F < 1 || (stride != 1 && stride != 2) ||
      (wd == nullptr && (Cin != Cout || stride != 1 || res_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto* xi = static_cast<const int8_t*>(x);
  const auto* w1i = static_cast<const int8_t*>(w1);
  const auto* w2i = static_cast<const int8_t*>(w2);
  const auto* wdi = static_cast<const int8_t*>(wd);
  const auto* a1f = static_cast<const float*>(a1);
  const auto* b1f = static_cast<const float*>(b1);
  const auto* a2f = static_cast<const float*>(a2);
  const auto* b2f = static_cast<const float*>(b2);
  const auto* adf = static_cast<const float*>(ad);
  const auto* bdf = static_cast<const float*>(bd);
  const auto* rs = static_cast<const float*>(res_scale);
  auto* o = static_cast<int8_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (wd != nullptr)
    return launch<true>(xi, w1i, a1f, b1f, w2i, a2f, b2f, wdi, adf, bdf, rs, o, N, H, W, Cin,
                        Cout, stride, F, st);
  return launch<false>(xi, w1i, a1f, b1f, w2i, a2f, b2f, wdi, adf, bdf, rs, o, N, H, W, Cin,
                       Cout, stride, F, st);
}
