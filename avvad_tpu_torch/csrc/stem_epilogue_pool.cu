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
// Design: one CTA per (frame, 16-channel group). Its threads read the group's
// 16 channel planes (contiguous in cuDNN's NCHW output; any strides are
// accepted, so channels-last input works too) with neighbouring threads on
// neighbouring pixels, quantise each value once, and keep the int8 results
// in shared memory as [pixel][16 channels]. Then one thread per output pixel
// takes the byte-wise max (__vmaxs4) of up to nine 16-byte rows and writes
// its 16 channels with one 16-byte store.

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
