// Train-mode BatchNorm of the float ResNet trunk for Hopper (sm_90a): one
// pass for the statistics, one pass that normalises and applies the block's
// shortcut and ReLU (at the stem also the 3x3/2 max pool).
//
// No TPU kernel stands behind these: the JAX package leaves BatchNorm to XLA,
// which fuses it with its neighbours. They replace plain PyTorch
// (ops/bn_fused.py: bn_stats_plain, bn_apply_plain; models/resnet.py's
// batch_norm, F.relu, the residual add and the stem's F.max_pool2d), which
// reads and writes each activation about nine times.
//
// What bounds them on an H100: bytes. At the AV training step (8,192 frames)
// the trunk's 20 BatchNorm inputs hold 8.35 GB of fp32: one read of each for
// the statistics, then one read and one write to normalise (the shortcut's
// tensor read once in the same pass) is 26.3 GB, 7.85 ms at 3.35 TB/s; with
// the stem's pool in its pass the stem writes a quarter, 24.5 GB, 7.31 ms.
// Both kernels do a few operations a byte.
//
// Both walk the tensor so that the CTAs resident at one time read a compact
// stretch of it (CTA b takes frames, or 2,048-value chunks, b, b + grid,
// b + 2 grid, ...): a run of the kernels with each CTA on its own distant
// stretch read 2.2-2.8 TB/s where PyTorch's own passes read 3.0.
//
// bn_stats: x (N, C, H, W) fp32, NCHW. Its eight warps split every frame into
// eight pieces of C/8 whole channels (the warp owns those channels'
// accumulators, so nothing is shared between warps). A lane loads 16 bytes at
// a time, neighbouring lanes on neighbouring addresses, whatever H x W is:
// each lane sums its four values by channel (four values span at most two
// channels where H x W >= 4), hands the part of the next channel to the lane
// after it, and a segmented suffix sum over the warp (five shuffles) leaves
// each channel's sum and sum of squares in the first lane that holds it,
// which adds them, in double, to the warp's accumulators in shared memory.
// Where H x W < 4 (a 1 x 1 to 1 x 3 plane: frames smaller than the trunk's
// 67 x 67) a lane takes whole channels instead, its H x W values as scalars,
// the warp's reads still one contiguous stretch.
// Each CTA writes its 2C partials contiguously; a second kernel adds the
// CTAs' partials in double in a fixed order. No atomics on values: a run
// repeats bit for bit on a card. From the sums it computes in double
// mean = S / n and var = max(Q / n - mean^2, 0) (flax's E[x^2] - E[x]^2),
// rounds both to fp32 once, and computes mul = rsqrt(var + eps) * weight and
// the running-statistics update ra = (1 - m) ra + m batch in fp32 as the
// plain version's separate operations.
//
// bn_apply: out = (x - mean) * mul + bias as __fsub_rn, __fmul_rn, __fadd_rn
// (no FMA contraction), then + shortcut, or + the shortcut's own
// normalisation (a downsample's BatchNorm, from its own statistics), then
// ReLU: the same separate fp32 operations as the plain version, so bit for bit
// given the same statistics. Each thread loads and stores 16 bytes at a time
// and works out the channel of each value (H x W may be odd, or under 4, so
// a group can span two channels or more). With the pool (the stem): a CTA
// normalises whole channel planes into shared memory and writes only the
// 3x3/2 maxima, the padding left out (F.max_pool2d's -inf padding); a plane
// too large for shared memory is pooled from x, each window normalised as it
// is read. A max is exact, so this too is bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256, WARPS = THREADS / 32;
constexpr int FIN_THREADS = 1024, FIN_WARPS = FIN_THREADS / 32;
constexpr int CHUNK4 = 2 * THREADS;     // float4s of an apply CTA's chunk
constexpr int POOL_SMEM = 48 * 1024;    // a pool CTA's planes at most
constexpr int POOL_LOADS = 8;           // a pool thread's loads in flight
constexpr int POOL_GROUP = 8192;        // values a pool CTA normalises at a time
constexpr unsigned FULL = 0xffffffffu;

// One warp step over 32 float4s of the warp's piece (float4 i4 = base + lane;
// the piece starts on a channel boundary, piece4 float4s long). ws, wq: the
// warp's accumulators, indexed by the channel within the piece.
__device__ __forceinline__ void stats_step(const float4 v, int base, int lane, int piece4, int hw,
                                           double* __restrict__ ws, double* __restrict__ wq) {
  const int i4 = base + lane;
  const bool valid = i4 < piece4;
  const int u = 4 * i4;
  const int cl = u / hw;
  const int r = u - cl * hw;  // the first value's offset in channel cl
  const int k = hw - r;       // values of channel cl in this float4, from the first
  const float e[4] = {v.x, v.y, v.z, v.w};
  float a = 0.f, aq = 0.f, b = 0.f, bq = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j < k) {
      a += e[j];
      aq += e[j] * e[j];
    } else {
      b += e[j];
      bq += e[j] * e[j];
    }
  }
  // the part of channel cl + 1 goes to the next lane, whose first value is in
  // that channel, unless this lane holds the step's or the piece's last float4
  const bool last = lane == 31 || i4 + 1 >= piece4;
  const float pb = __shfl_up_sync(FULL, b, 1), pbq = __shfl_up_sync(FULL, bq, 1);
  if (lane > 0 && valid) {
    a += pb;
    aq += pbq;
  }
  // lanes [lane, seg_end) start in channel cl
  const int seg_end = min(32, ((cl + 1) * hw + 3) / 4 - base);
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float oa = __shfl_down_sync(FULL, a, off), oq = __shfl_down_sync(FULL, aq, off);
    if (lane + off < seg_end) {
      a += oa;
      aq += oq;
    }
  }
  if (valid && (lane == 0 || r < 4)) {  // the first lane of channel cl in this step
    ws[cl] += (double)a;
    wq[cl] += (double)aq;
  }
  if (valid && last && k < 4) {
    ws[cl + 1] += (double)b;
    wq[cl + 1] += (double)bq;
  }
  __syncwarp();
}

// part: [gridDim.x][2][C] doubles, each CTA's sums then sums of squares.
__global__ void __launch_bounds__(THREADS)
bn_stats_partial_kernel(const float* __restrict__ x, double* __restrict__ part, int n, int c,
                        int hw) {
  extern __shared__ double acc[];  // [2][C]
  for (int i = threadIdx.x; i < 2 * c; i += THREADS) acc[i] = 0.0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cw = c / WARPS, piece4 = cw * hw / 4;
  double* ws = acc + warp * cw;
  double* wq = acc + c + warp * cw;
  const long long frame = (long long)c * hw;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int f = blockIdx.x; f < n; f += gridDim.x) {
    if (hw < 4) {
      const float* p = x + f * frame + (long long)warp * cw * hw;
      for (int cl = lane; cl < cw; cl += 32) {
        float a = 0.f, aq = 0.f;
        for (int j = 0; j < hw; ++j) {
          const float e = __ldg(p + cl * hw + j);
          a += e;
          aq += e * e;
        }
        ws[cl] += (double)a;
        wq[cl] += (double)aq;
      }
      continue;
    }
    const float4* p = reinterpret_cast<const float4*>(x + f * frame) + warp * piece4;
    for (int base = 0; base < piece4; base += 64) {  // two loads in flight a lane
      const int i0 = base + lane, i1 = i0 + 32;
      const float4 v0 = i0 < piece4 ? __ldg(p + i0) : zero;
      const float4 v1 = i1 < piece4 ? __ldg(p + i1) : zero;
      stats_step(v0, base, lane, piece4, hw, ws, wq);
      if (base + 32 < piece4) stats_step(v1, base + 32, lane, piece4, hw, ws, wq);
    }
  }
  __syncthreads();
  double* out = part + (long long)blockIdx.x * 2 * c;
  for (int i = threadIdx.x; i < 2 * c; i += THREADS) out[i] = acc[i];
}

// A CTA a tile of 32 channels: warp w adds the partials of CTAs
// [w ctas / FIN_WARPS, (w + 1) ctas / FIN_WARPS) in order, then warp 0 adds
// the warps' sums in order and computes the statistics. stats: [3][C] fp32
// mean, var, mul.
__global__ void __launch_bounds__(FIN_THREADS)
bn_stats_finish_kernel(const double* __restrict__ part, int ctas, const float* __restrict__ weight,
                       float* __restrict__ running_mean, float* __restrict__ running_var,
                       float* __restrict__ stats, int c, double count, float eps, float keep,
                       float momentum, int update) {
  __shared__ double red[2][FIN_WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, ch = blockIdx.x * 32 + lane;
  double s = 0.0, q = 0.0;
  if (ch < c) {
    const int g1 = (int)((long long)ctas * (warp + 1) / FIN_WARPS);
    for (int g = (int)((long long)ctas * warp / FIN_WARPS); g < g1; ++g) {
      s += part[(long long)g * 2 * c + ch];
      q += part[(long long)g * 2 * c + c + ch];
    }
  }
  red[0][warp][lane] = s;
  red[1][warp][lane] = q;
  __syncthreads();
  if (warp || ch >= c) return;
  s = q = 0.0;
  for (int w = 0; w < FIN_WARPS; ++w) {
    s += red[0][w][lane];
    q += red[1][w][lane];
  }
  const double mean = s / count, d = __dsub_rn(q / count, __dmul_rn(mean, mean));
  const double var = d < 0.0 ? 0.0 : d;  // NaN passes, as torch.clamp
  const float mf = __double2float_rn(mean), vf = __double2float_rn(var);
  stats[ch] = mf;
  stats[c + ch] = vf;
  stats[2 * c + ch] = __fmul_rn(rsqrtf(__fadd_rn(vf, eps)), weight[ch]);
  if (update) {
    running_mean[ch] = __fadd_rn(__fmul_rn(keep, running_mean[ch]), __fmul_rn(momentum, mf));
    running_var[ch] = __fadd_rn(__fmul_rn(keep, running_var[ch]), __fmul_rn(momentum, vf));
  }
}

struct ApplyArgs {
  const float* x;
  const float* shortcut;
  const float* mean;
  const float* mul;
  const float* bias;
  const float* sc_mean;
  const float* sc_mul;
  const float* sc_bias;
  float* out;
  long long total4;  // float4s of x
  int c, hw;
};

__device__ __forceinline__ float normalise(float v, const float* p, int ch, int c) {
  return __fadd_rn(__fmul_rn(__fsub_rn(v, p[ch]), p[c + ch]), p[2 * c + ch]);
}

__device__ __forceinline__ float relu(float y) { return y < 0.f ? 0.f : y; }  // NaN passes

// RES: 0 none, 1 + shortcut, 2 + the shortcut normalised by prm[3C..6C).
// The four values start in channel ch, k of them (>= 1) in it; each further
// hw values lie in the next channel (more than one step where hw < 4).
template <int RES, bool RELU>
__device__ __forceinline__ float4 apply4(float4 xv, float4 sv, const float* p, int ch, int k,
                                         int c, int hw) {
  float xs[4] = {xv.x, xv.y, xv.z, xv.w};
  const float ss[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j == k) {
      ch = ch + 1 == c ? 0 : ch + 1;
      k += hw;
    }
    float y = normalise(xs[j], p, ch, c);
    if (RES == 1) y = __fadd_rn(y, ss[j]);
    if (RES == 2) y = __fadd_rn(y, normalise(ss[j], p + 3 * c, ch, c));
    if (RELU) y = relu(y);
    xs[j] = y;
  }
  return make_float4(xs[0], xs[1], xs[2], xs[3]);
}

__device__ __forceinline__ void load_vectors(const ApplyArgs& a, int nv, float* prm) {
  const float* v[6] = {a.mean, a.mul, a.bias, a.sc_mean, a.sc_mul, a.sc_bias};
  for (int s = 0; s < nv; ++s)
    for (int i = threadIdx.x; i < a.c; i += blockDim.x) prm[s * a.c + i] = v[s][i];
}

// CTA b takes chunks b, b + grid, ... of CHUNK4 float4s; a thread the float4s
// threadIdx.x and threadIdx.x + THREADS of each.
template <int RES, bool RELU>
__global__ void __launch_bounds__(THREADS) bn_apply_kernel(const ApplyArgs a) {
  extern __shared__ float prm[];  // [3 or 6][C]
  const int c = a.c, hw = a.hw;
  load_vectors(a, RES == 2 ? 6 : 3, prm);
  __syncthreads();
  const long long step4 = (long long)gridDim.x * CHUNK4;
  // where the chunk's first value lies: channel row r0 (frame-major) mod C
  // (cb), offset r in it; and how far a step moves both
  long long v = (long long)blockIdx.x * CHUNK4;
  const long long q0 = 4 * v / hw, dq = 4 * step4 / hw;
  unsigned r = (unsigned)(4 * v - q0 * hw), cb = (unsigned)(q0 % c);
  const unsigned dr = (unsigned)(4 * step4 - dq * hw), dcb = (unsigned)(dq % c);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4* x4 = reinterpret_cast<const float4*>(a.x);
  const float4* s4 = reinterpret_cast<const float4*>(a.shortcut);
  float4* o4 = reinterpret_cast<float4*>(a.out);
  for (; v < a.total4; v += step4) {
    const long long i0 = v + threadIdx.x, i1 = i0 + THREADS;
    const bool has0 = i0 < a.total4, has1 = i1 < a.total4;
    const float4 xa = has0 ? __ldg(x4 + i0) : zero, xb = has1 ? __ldg(x4 + i1) : zero;
    const float4 sa = RES && has0 ? __ldg(s4 + i0) : zero, sb = RES && has1 ? __ldg(s4 + i1) : zero;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(h ? has1 : has0)) break;
      const unsigned t = r + 4u * (threadIdx.x + h * THREADS);
      const unsigned q = t / hw;
      const int k = (int)((q + 1) * hw - t);  // values of the first channel, >= 1
      o4[h ? i1 : i0] = apply4<RES, RELU>(h ? xb : xa, h ? sb : sa, prm, (int)((cb + q) % c),
                                          k, c, hw);
    }
    r += dr;
    cb += dcb;
    if (r >= (unsigned)hw) {
      r -= hw;
      ++cb;
    }
    if (cb >= (unsigned)c) cb -= c;
  }
}

// The 3x3/2 max (padding 1) at output (py, px) of the (h, w) plane s. The
// window's rows and columns are clamped into the plane: a clamped index
// repeats one inside the window, which leaves its max as it is (the padding,
// -inf, never wins). NORM: s holds conv outputs of channel ch, each
// normalised (and put through the ReLU) as it is read; else finished values.
template <bool NORM, bool RELU>
__device__ __forceinline__ float window_max(const float* s, int h, int w, int py, int px,
                                            const float* prm, int ch, int c) {
  const int ys[3] = {max(2 * py - 1, 0), 2 * py, min(2 * py + 1, h - 1)};
  const int xs[3] = {max(2 * px - 1, 0), 2 * px, min(2 * px + 1, w - 1)};
  float best = -INFINITY;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      float val = s[ys[dy] * w + xs[dx]];
      if (NORM) {
        val = normalise(val, prm, ch, c);
        if (RELU) val = relu(val);
      }
      if (val > best || val != val) best = val;  // as F.max_pool2d: NaN wins
    }
  return best;
}

// The stem's form: normalise (and ReLU) whole (H, W) channel planes into
// shared memory, ppc planes at a time (CTA b takes groups b, b + grid, ...),
// then the 3x3/2 max pool with padding 1, the padding left out.
template <bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_apply_pool_kernel(const ApplyArgs a, long long planes, int h, int w, int oh, int ow, int ppc) {
  extern __shared__ float sm[];  // [3][C] vectors, then ppc planes
  const int c = a.c, hw = a.hw, ohw = oh * ow;
  load_vectors(a, 3, sm);
  float* pl = sm + 3 * c;
  for (long long p0 = (long long)blockIdx.x * ppc; p0 < planes; p0 += (long long)gridDim.x * ppc) {
    __syncthreads();  // the vectors loaded; the group before pooled
    const int np = (int)min((long long)ppc, planes - p0), cnt = np * hw;
    const float* src = a.x + p0 * hw;
    // value i of the group: offset j in its plane, channel ch, followed as i
    // grows; POOL_LOADS loads in flight a thread
    const int pi = threadIdx.x / hw;
    int j = threadIdx.x - pi * hw, ch = (int)((p0 + pi) % c);
    for (int i0 = threadIdx.x; i0 < cnt; i0 += POOL_LOADS * THREADS) {
      float v[POOL_LOADS];
#pragma unroll
      for (int u = 0; u < POOL_LOADS; ++u) {
        const int i = i0 + u * THREADS;
        v[u] = i < cnt ? __ldg(src + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < POOL_LOADS; ++u) {
        const int i = i0 + u * THREADS;
        if (i < cnt) {
          float y = normalise(v[u], sm, ch, c);
          if (RELU) y = relu(y);
          pl[i] = y;
        }
        for (j += THREADS; j >= hw; j -= hw)
          if (++ch == c) ch = 0;
      }
    }
    __syncthreads();
    float* dst = a.out + p0 * ohw;
    for (int o = threadIdx.x; o < np * ohw; o += THREADS) {
      const int po = o / ohw, rem = o - po * ohw, py = rem / ow, px = rem - py * ow;
      dst[o] = window_max<false, RELU>(pl + po * hw, h, w, py, px, sm, 0, c);
    }
  }
}

// The pool where one plane does not fit in shared memory (a stem plane over
// POOL_SMEM, from frames over about 220 x 220): a thread an output, its
// window read from x and normalised as it is read (neighbouring windows
// overlap, so most of the reads hit the caches).
template <bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_apply_pool_direct_kernel(const ApplyArgs a, long long outs, int h, int w, int oh, int ow) {
  extern __shared__ float prm[];  // [3][C]
  const int c = a.c, ohw = oh * ow;
  load_vectors(a, 3, prm);
  __syncthreads();
  for (long long o = (long long)blockIdx.x * THREADS + threadIdx.x; o < outs;
       o += (long long)gridDim.x * THREADS) {
    const long long plane = o / ohw;
    const int rem = (int)(o - plane * ohw), py = rem / ow, px = rem - py * ow;
    a.out[o] = window_max<true, RELU>(a.x + plane * a.hw, h, w, py, px, prm, (int)(plane % c),
                                      c);
  }
}

cudaError_t resident_ctas(const void* kernel, int threads, size_t smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = sms * per_sm;
  return cudaSuccess;
}

template <int RES, bool RELU>
int launch_apply(const ApplyArgs& a, cudaStream_t st) {
  const size_t smem = (size_t)(RES == 2 ? 6 : 3) * a.c * sizeof(float);
  const void* kernel = reinterpret_cast<const void*>(bn_apply_kernel<RES, RELU>);
  int slots = 0;
  cudaError_t e = resident_ctas(kernel, THREADS, smem, &slots);
  if (e != cudaSuccess) return (int)e;
  const long long need = (a.total4 + CHUNK4 - 1) / CHUNK4;
  const int grid = (int)(need < slots ? need : slots);
  bn_apply_kernel<RES, RELU><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <bool RELU>
int launch_pool(const ApplyArgs& a, long long planes, int h, int w, cudaStream_t st) {
  const int oh = (h - 1) / 2 + 1, ow = (w - 1) / 2 + 1;
  cudaError_t e;
  int slots = 0;
  if ((size_t)a.hw * sizeof(float) > POOL_SMEM) {
    const size_t smem = (size_t)3 * a.c * sizeof(float);
    const void* kernel = reinterpret_cast<const void*>(bn_apply_pool_direct_kernel<RELU>);
    if ((e = resident_ctas(kernel, THREADS, smem, &slots)) != cudaSuccess) return (int)e;
    const long long outs = planes * oh * ow, need = (outs + THREADS - 1) / THREADS;
    const int grid = (int)(need < slots ? need : slots);
    bn_apply_pool_direct_kernel<RELU><<<grid, THREADS, smem, st>>>(a, outs, h, w, oh, ow);
    return (int)cudaGetLastError();
  }
  // whole planes, about POOL_GROUP values a CTA at a time
  const int ppc = a.hw >= POOL_GROUP ? 1 : POOL_GROUP / a.hw;
  const size_t smem = (size_t)(3 * a.c + ppc * a.hw) * sizeof(float);
  const void* kernel = reinterpret_cast<const void*>(bn_apply_pool_kernel<RELU>);
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return (int)e;
  if ((e = resident_ctas(kernel, THREADS, smem, &slots)) != cudaSuccess) return (int)e;
  const long long need = (planes + ppc - 1) / ppc;
  const int grid = (int)(need < slots ? need : slots);
  bn_apply_pool_kernel<RELU><<<grid, THREADS, smem, st>>>(a, planes, h, w, oh, ow, ppc);
  return (int)cudaGetLastError();
}

}  // namespace

// The statistics kernel's grid for N frames of C channels, into *ctas: one
// wave of the CTAs resident at once, the frames split as evenly as whole
// frames allow. bn_stats' scratch holds 2 * C doubles a CTA. Returns the
// CUDA error, else 0.
extern "C" int bn_stats_ctas(int N, int C, int* ctas) {
  if (N <= 0 || C <= 0 || C % (4 * WARPS) || !ctas) return (int)cudaErrorInvalidValue;
  int slots = 0;
  const cudaError_t e = resident_ctas(reinterpret_cast<const void*>(bn_stats_partial_kernel),
                                      THREADS, 2 * (size_t)C * sizeof(double), &slots);
  if (e != cudaSuccess) return (int)e;
  const int fpc = (N + slots - 1) / slots;
  *ctas = (N + fpc - 1) / fpc;
  return 0;
}

// x: (N, C, HW) fp32, contiguous, 16-byte aligned; weight, running_mean,
// running_var: (C,) fp32; partials: 2 * C * ctas doubles of scratch, ctas
// from bn_stats_ctas; stats: (3, C) fp32 out (mean, biased var,
// rsqrt(var + eps) * weight). C % 32 == 0, 32 <= C <= 2048, HW >= 1 (the
// wrapper checks). update: apply the running-statistics update with
// keep = 1 - momentum. Two launches on the stream; returns the first CUDA
// error, else 0.
extern "C" int bn_stats(const void* x, const void* weight, void* running_mean, void* running_var,
                        void* partials, int ctas, void* stats, int N, int C, int HW,
                        float eps, float keep, float momentum, int update, void* stream) {
  if (N <= 0 || C <= 0 || C % (4 * WARPS) || HW < 1 || ctas < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)C * sizeof(double);
  const auto st = static_cast<cudaStream_t>(stream);
  auto* part = static_cast<double*>(partials);
  bn_stats_partial_kernel<<<ctas, THREADS, smem, st>>>(static_cast<const float*>(x), part, N, C,
                                                       HW);
  cudaError_t e;
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bn_stats_finish_kernel<<<(C + 31) / 32, FIN_THREADS, 0, st>>>(
      part, ctas, static_cast<const float*>(weight), static_cast<float*>(running_mean),
      static_cast<float*>(running_var), static_cast<float*>(stats), C, (double)N * HW, eps, keep,
      momentum, update);
  return (int)cudaGetLastError();
}

// x, shortcut (or null): (N, C, H, W) fp32, contiguous, 16-byte aligned;
// mean, mul, bias and the shortcut's (or null): (C,) fp32; out: x's shape, or
// with pool (N, C, (H - 1) / 2 + 1, (W - 1) / 2 + 1). res: 0 no shortcut, 1
// + shortcut, 2 + the shortcut normalised by its own vectors; relu: then
// max(., 0); pool: then the 3x3/2 max pool, padding 1 (res 0 only). C % 4
// == 0, C <= 2048. One launch.
extern "C" int bn_apply(const void* x, const void* mean, const void* mul, const void* bias,
                        const void* shortcut, const void* sc_mean, const void* sc_mul,
                        const void* sc_bias, void* out, int N, int C, int H, int W, int res,
                        int relu, int pool, void* stream) {
  const int hw = H * W;
  if (N <= 0 || C <= 0 || C % 4 || H <= 0 || W <= 0 || res < 0 || res > 2 ||
      (res && !shortcut) || (res == 2 && !(sc_mean && sc_mul && sc_bias)) || (pool && res) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16 || reinterpret_cast<uintptr_t>(shortcut) % 16)
    return (int)cudaErrorInvalidValue;
  ApplyArgs a{static_cast<const float*>(x),       static_cast<const float*>(shortcut),
              static_cast<const float*>(mean),    static_cast<const float*>(mul),
              static_cast<const float*>(bias),    static_cast<const float*>(sc_mean),
              static_cast<const float*>(sc_mul),  static_cast<const float*>(sc_bias),
              static_cast<float*>(out),           (long long)N * C * hw / 4,
              C,                                  hw};
  const auto st = static_cast<cudaStream_t>(stream);
  if (pool)
    return relu ? launch_pool<true>(a, (long long)N * C, H, W, st)
                : launch_pool<false>(a, (long long)N * C, H, W, st);
  if (relu) {
    if (res == 0) return launch_apply<0, true>(a, st);
    if (res == 1) return launch_apply<1, true>(a, st);
    return launch_apply<2, true>(a, st);
  }
  if (res == 0) return launch_apply<0, false>(a, st);
  if (res == 1) return launch_apply<1, false>(a, st);
  return launch_apply<2, false>(a, st);
}
