// Fused ResNet stem epilogue for Hopper (sm_90a): folded BatchNorm affine,
// ReLU, int8 requantisation and the 3x3/2 max pool in one pass.
//
// Replaces avvad_tpu/ops/stem_pallas.py `_stem_epilogue_kernel`, called
// through `stem_epilogue_pool_quant` (stem_pallas.py:72). For the stem conv's
// output x (N, C, 34, 34) and the folded (C,) vectors a, b:
//   q   = min(rint(max(a * x + b, 0)), 127)        (int8, per input pixel)
//   out = max of q over the 3x3 stride-2 window, padding excluded
// -> (N, 17, 17, C) int8, NHWC. Quantising before the pool is exact: max
// commutes with the monotone round and clip (stem_pallas.py:52-57).
//
// Numerics: a * x + b as __fmul_rn then __fadd_rn (no FMA contraction) and
// rintf (half to even), so the kernel is bit-identical to its plain PyTorch
// version, which computes the same separate float32 operations.
//
// What bounds it on an H100: bytes. At the serving shape (15,744 frames,
// C = 64) it reads 2.33 GB of bf16 conv output and writes 0.29 GB of int8,
// 0.78 ms at 3.35 TB/s; it does about 10 operations per input byte.
//
// Two kernels, routed by the input's layout (ops/stem_fused.py):
//
// stem_epilogue_pool (NCHW input, cuDNN's default): one CTA per (frame,
// 16-channel group). Its threads read the group's 16 channel planes with
// neighbouring threads on neighbouring pixels, quantise each value once, and
// keep the int8 results in shared memory as [pixel][16 channels]. Then one
// thread per output pixel takes the byte-wise max (__vmaxs4) of up to nine
// 16-byte rows and writes its 16 channels with one 16-byte store. It keeps
// one 2-byte load in flight a thread (about 4 KB an SM) and pools in a phase
// with no loads under it: 28 % of the byte bound on an H100.
//
// stem_epilogue_pool_nhwc (channels-last input, what the int8 tower's stem
// conv writes): a persistent grid, as many CTAs as the SMs hold, each walking
// its units (a frame, or a frame's slice of CS channels where a pixel's C
// channels are more than 256 bytes; the wrapper's nhwc_plan sets CS and the
// ring's slots) as a stream of chunks, one chunk an
// output row: input rows 2p and 2p+1 (2 x 34 x CS values; 8,704 bytes at C =
// 64 in bf16, contiguous in NHWC, so one cp.async.bulk). The chunks land in
// a ring of up to 64 KB (7 chunks in bf16) on mbarriers, issued by one warp
// as soon as a slot is free, so every SM keeps tens of KB in flight while its
// CTAs pool the chunks that have arrived. A thread owns 8 channels of one
// output column (16-byte loads of bf16): it takes the horizontal max of rows
// 2p and 2p+1 over input columns 2q-1, 2q, 2q+1, the max of the two with row
// 2p-1's (kept from the chunk before), then quantises the 8 maxima and two
// neighbouring threads write their 16 channels with one 16-byte store.
// Pooling before quantising is exact: for a channel with a >= +0,
// q = clip(rint(relu(a * x + b))) does not decrease with x (every step,
// rounded multiply and add included, is monotone), so max q = q(max x); for
// one with a negative sign bit it does not increase, so max q = q(min x),
// taken as the max of -x (the sign bit flipped, exact) and flipped back. So
// each input value costs one max and one sign flip, and 289 values a channel
// are quantised instead of 1,156 (x finite, as a conv's output is).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int HI = 34, HO = 17, CG = 16, THREADS = 256;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_epilogue_pool_kernel(const T* __restrict__ x, const float* __restrict__ a,
                          const float* __restrict__ b, int8_t* __restrict__ out, int C,
                          long long sN, long long sC, long long sH, long long sW) {
  __shared__ __align__(16) int8_t q[HI * HI * CG];
  const int n = blockIdx.x, c0 = blockIdx.y * CG;
  const T* xn = x + n * sN;
  for (int i = threadIdx.x; i < CG * HI * HI; i += THREADS) {
    const int cl = i / (HI * HI), hw = i - cl * (HI * HI);
    const int h = hw / HI, w = hw - h * HI, c = c0 + cl;
    const float y = __fadd_rn(__fmul_rn(load(xn + c * sC + h * sH + w * sW), a[c]), b[c]);
    q[hw * CG + cl] = (int8_t)fminf(rintf(fmaxf(y, 0.0f)), 127.0f);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < HO * HO; p += THREADS) {
    const int oh = p / HO, ow = p - oh * HO;
    uint4 m = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);  // -128
    for (int dy = 0; dy < 3; ++dy) {
      const int h = 2 * oh - 1 + dy;
      if (h < 0 || h >= HI) continue;
      for (int dx = 0; dx < 3; ++dx) {
        const int w = 2 * ow - 1 + dx;
        if (w < 0 || w >= HI) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(q + (h * HI + w) * CG);
        m.x = __vmaxs4(m.x, v.x);
        m.y = __vmaxs4(m.y, v.y);
        m.z = __vmaxs4(m.z, v.z);
        m.w = __vmaxs4(m.w, v.w);
      }
    }
    *reinterpret_cast<uint4*>(out + ((size_t)n * HO * HO + p) * C + c0) = m;
  }
}

// --- the channels-last kernel ---

constexpr int NT_L = 256;     // threads of a CTA
constexpr int MAX_SLOTS = 8;  // chunks in the ring at most (its mbarriers)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// one contiguous run of bytes, global -> shared, completion counted on `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Eight channels of one pixel as 32-bit words: 4 of bf16 pairs or 8 floats
template <typename T>
struct Oct;

template <>
struct Oct<__nv_bfloat16> {
  static constexpr int W = 4;
  __device__ static unsigned vmax(unsigned p, unsigned q) {
    const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&p),
                                     *reinterpret_cast<const __nv_bfloat162*>(&q));
    return *reinterpret_cast<const unsigned*>(&r);
  }
  __device__ static float value(const unsigned (&v)[W], int i) {  // bf16 -> f32: a shift
    return __uint_as_float(i & 1 ? v[i >> 1] & 0xffff0000u : v[i >> 1] << 16);
  }
  __device__ static unsigned sign(const float* a, int w) {  // the sign bits of word w
    return (__float_as_uint(a[2 * w]) >> 16 & 0x8000u) | (__float_as_uint(a[2 * w + 1]) & 0x80000000u);
  }
};

template <>
struct Oct<float> {
  static constexpr int W = 8;
  __device__ static unsigned vmax(unsigned p, unsigned q) {
    return __float_as_uint(fmaxf(__uint_as_float(p), __uint_as_float(q)));
  }
  __device__ static float value(const unsigned (&v)[W], int i) { return __uint_as_float(v[i]); }
  __device__ static unsigned sign(const float* a, int w) { return __float_as_uint(a[w]) & 0x80000000u; }
};

// the 8 channels at p (16-byte aligned) with the sign bits s flipped
template <typename T>
__device__ __forceinline__ void load_oct(unsigned (&v)[Oct<T>::W], const unsigned char* p,
                                         const unsigned (&s)[Oct<T>::W]) {
#pragma unroll
  for (int i = 0; i < Oct<T>::W / 4; ++i) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + 16 * i);
    v[4 * i] = q.x ^ s[4 * i];
    v[4 * i + 1] = q.y ^ s[4 * i + 1];
    v[4 * i + 2] = q.z ^ s[4 * i + 2];
    v[4 * i + 3] = q.w ^ s[4 * i + 3];
  }
}

template <typename T>
__device__ __forceinline__ void max_oct(unsigned (&v)[Oct<T>::W], const unsigned (&o)[Oct<T>::W]) {
#pragma unroll
  for (int i = 0; i < Oct<T>::W; ++i) v[i] = Oct<T>::vmax(v[i], o[i]);
}

// the horizontal 3/2 max of one input row at output column q: input columns
// 2q - 1 (absent at q = 0), 2q and 2q + 1
template <typename T>
__device__ __forceinline__ void row_max(unsigned (&v)[Oct<T>::W], const unsigned char* row, int q,
                                        int px_bytes, const unsigned (&s)[Oct<T>::W]) {
  unsigned o[Oct<T>::W];
  load_oct<T>(v, row + 2 * q * px_bytes, s);
  load_oct<T>(o, row + (2 * q + 1) * px_bytes, s);
  max_oct<T>(v, o);
  if (q > 0) {
    load_oct<T>(o, row + (2 * q - 1) * px_bytes, s);
    max_oct<T>(v, o);
  }
}

// Shared memory of a CTA: the mbarriers, a and b (C floats each), the row
// 2p + 1 maxima of every item (items x 8 channels), then the ring from a
// 128-byte boundary.
__host__ __device__ __forceinline__ int ring_offset(int C, int CS, int es) {
  const int items = HO * CS / 8;
  return (MAX_SLOTS * 8 + 8 * C + items * 8 * es + 127) / 128 * 128;
}

struct NhwcArgs {
  const unsigned char* x;  // (N, 34, 34, C) values of es bytes
  const float* a;
  const float* b;
  int8_t* out;             // (N, 17, 17, C)
  int N, C, CS, slots;     // CS: channels of a unit; slots: chunks in the ring
};

// CTA r owns units r, r + gridDim.x, ... (unit u: frame u / (C / CS), channel
// slice u % (C / CS)); its chunk s is output row s % 17 of its unit s / 17,
// in ring slot s % slots, whose mbarrier completes its (s / slots)-th phase.
template <typename T>
__global__ void __launch_bounds__(NT_L, 3) stem_epilogue_pool_nhwc_kernel(const NhwcArgs p) {
  typedef Oct<T> O;
  constexpr int W = O::W, ES = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  float* as = reinterpret_cast<float*>(smem + MAX_SLOTS * 8);
  float* bs = as + p.C;
  unsigned* carry = reinterpret_cast<unsigned*>(bs + p.C);
  unsigned char* ring = smem + ring_offset(p.C, p.CS, ES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nslice = p.C / p.CS, octs = p.CS / 8, items = HO * octs;
  const int px_bytes = p.CS * ES, chunk = 2 * HI * px_bytes;
  const int units = p.N * nslice;
  const int nchunks = (units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * HO;

  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = tid; c < p.C; c += NT_L) {
    as[c] = p.a[c];
    bs[c] = p.b[c];
  }
  __syncthreads();

  // chunk s into its slot: warp 0 (a whole unit's row pair is one copy where
  // CS == C, else one copy a pixel of 2 x 34)
  auto issue = [&](int s) {
    const int u = (int)blockIdx.x + s / HO * (int)gridDim.x, pr = s % HO;
    const int f = u / nslice, sl = u % nslice;
    const uint32_t bar = smem_u32(full + s % p.slots);
    const uint32_t dst = smem_u32(ring + (size_t)(s % p.slots) * chunk);
    const unsigned char* src = p.x + (((size_t)f * HI + 2 * pr) * HI * p.C + (size_t)sl * p.CS) * ES;
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(chunk)
                   : "memory");
    __syncwarp();
    if (nslice == 1) {
      if (lane == 0) bulk_g2s(dst, src, chunk, bar);
    } else {
      for (int px = lane; px < 2 * HI; px += 32)
        bulk_g2s(dst + px * px_bytes, src + (size_t)px * p.C * ES, px_bytes, bar);
    }
  };
  if (warp == 0)
    for (int s = 0; s < p.slots && s < nchunks; ++s) issue(s);

  for (int s = 0; s < nchunks; ++s) {
    mbar_wait(smem_u32(full + s % p.slots), (s / p.slots) & 1);
    const int u = (int)blockIdx.x + s / HO * (int)gridDim.x, pr = s % HO;
    const int f = u / nslice, sl = u % nslice;
    const unsigned char* rows = ring + (size_t)(s % p.slots) * chunk;
    // every thread runs every round, so that neighbouring lanes can pair up
    for (int base = 0; base < items; base += NT_L) {
      const int it = base + tid;
      const bool valid = it < items;
      const int q = it / octs, o = it % octs, c0 = sl * p.CS + o * 8;
      unsigned lo = 0u, hi = 0u;
      if (valid) {
        const float* a = as + c0;
        const float* b = bs + c0;
        unsigned sg[W];
#pragma unroll
        for (int i = 0; i < W; ++i) sg[i] = O::sign(a, i);
        unsigned v[W], r1[W];
        row_max<T>(v, rows + o * 8 * ES, q, px_bytes, sg);
        row_max<T>(r1, rows + HI * px_bytes + o * 8 * ES, q, px_bytes, sg);
        max_oct<T>(v, r1);
        unsigned* cw = carry + (size_t)it * W;
        if (pr > 0) {  // row 2p - 1, from the chunk before
          unsigned prev[W];
#pragma unroll
          for (int i = 0; i < W; ++i) prev[i] = cw[i];
          max_oct<T>(v, prev);
        }
        if (pr + 1 < HO) {
#pragma unroll
          for (int i = 0; i < W; ++i) cw[i] = r1[i];
        }
#pragma unroll
        for (int i = 0; i < W; ++i) v[i] ^= sg[i];  // the max of x, or the min where a < 0
        unsigned qb[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float y = __fadd_rn(__fmul_rn(O::value(v, i), a[i]), b[i]);
          qb[i] = (unsigned)__float2int_rn(fminf(fmaxf(y, 0.0f), 127.0f));  // rint, half to even
        }
        lo = __byte_perm(__byte_perm(qb[0], qb[1], 0x0040), __byte_perm(qb[2], qb[3], 0x0040),
                         0x5410);
        hi = __byte_perm(__byte_perm(qb[4], qb[5], 0x0040), __byte_perm(qb[6], qb[7], 0x0040),
                         0x5410);
      }
      // octets o and o + 1 (o even) are neighbouring lanes: one 16-byte store
      const unsigned lo2 = __shfl_down_sync(0xffffffffu, lo, 1);
      const unsigned hi2 = __shfl_down_sync(0xffffffffu, hi, 1);
      if (valid && !(o & 1))
        *reinterpret_cast<uint4*>(p.out + (((size_t)f * HO + pr) * HO + q) * p.C + c0) =
            make_uint4(lo, hi, lo2, hi2);
    }
    __syncthreads();  // every thread is done with the slot
    if (warp == 0 && s + p.slots < nchunks) issue(s + p.slots);
  }
}

}  // namespace

// x: N x C x 34 x 34 values (float32, or bfloat16 when is_bf16) at element
// strides sN, sC, sH, sW; a, b (C,) f32; out (N, 17, 17, C) int8. C % 16 == 0.
// Returns the launch's cudaError_t (0 on success).
extern "C" int stem_epilogue_pool(const void* x, const void* a, const void* b, void* out,
                                  int N, int C, int sN, int sC, int sH, int sW, int is_bf16,
                                  void* stream) {
  if (N <= 0) return 0;
  if (C % CG) return (int)cudaErrorInvalidValue;
  const dim3 grid(N, C / CG);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  auto* o = static_cast<int8_t*>(out);
  if (is_bf16)
    stem_epilogue_pool_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), af, bf, o, C, sN, sC, sH, sW);
  else
    stem_epilogue_pool_kernel<float><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), af, bf, o, C, sN, sC, sH, sW);
  return (int)cudaGetLastError();
}

// x: (N, 34, 34, C) values (channels-last (N, C, 34, 34); float32, or
// bfloat16 when is_bf16), 16-byte aligned; a, b (C,) f32; out (N, 17, 17, C)
// int8; cs: the channels of a unit and slots: the ring's chunks, from
// ops/stem_fused.nhwc_plan (C % cs == 0, cs % 16 == 0, 1 <= slots <=
// MAX_SLOTS). One launch of a persistent grid: as many CTAs as the SMs hold
// beside each other, at most one a unit. Returns the first CUDA error, else 0.
extern "C" int stem_epilogue_pool_nhwc(const void* x, const void* a, const void* b, void* out,
                                       int N, int C, int cs, int slots, int is_bf16,
                                       void* stream) {
  if (N <= 0) return 0;
  if (C <= 0 || cs <= 0 || cs % 16 || C % cs || slots < 1 || slots > MAX_SLOTS ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const int es = is_bf16 ? 2 : 4, chunk = 2 * HI * cs * es;
  const size_t smem = (size_t)ring_offset(C, cs, es) + (size_t)slots * chunk;
  const void* kernel = is_bf16 ? reinterpret_cast<const void*>(stem_epilogue_pool_nhwc_kernel<__nv_bfloat16>)
                               : reinterpret_cast<const void*>(stem_epilogue_pool_nhwc_kernel<float>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT_L, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long units = (long long)N * (C / cs);
  const int grid = (int)(units < (long long)sms * per_sm ? units : (long long)sms * per_sm);
  NhwcArgs args{static_cast<const unsigned char*>(x), static_cast<const float*>(a),
                static_cast<const float*>(b), static_cast<int8_t*>(out), N, C, cs, slots};
  const auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    stem_epilogue_pool_nhwc_kernel<__nv_bfloat16><<<grid, NT_L, smem, st>>>(args);
  else
    stem_epilogue_pool_nhwc_kernel<float><<<grid, NT_L, smem, st>>>(args);
  return (int)cudaGetLastError();
}
