// LSTM forward recurrence for Hopper (sm_90a): one kernel launch per time
// step, driven by a host loop on the caller's stream.
//
// Replaces the forward Pallas kernels of avvad_tpu/ops/lstm_pallas.py:
//   lstm_f32h   <- _lstm_kernel       via _fwd_infer_call  (state_quant "none")
//   lstm_bf16h  <- _lstm_kernel_hbf16 via _fwd_quant_call  (state_quant "bf16")
//   lstm_int8   <- _lstm_kernel_int8  via _fwd_quant_call  (state_quant "int8")
//   lstm_fwd_train_f32h <- _lstm_fwd_train_kernel via _fwd_train_call (the
//       forward of training: lstm_f32h plus two stores per cell, c_t and the
//       post-activation gates [i, f, g, o], the residuals of the backward in
//       lstm_train.cu; a compile-time mode, so lstm_f32h's code is unchanged)
//   lstm_probe  <- the probe kernel of scripts/bench_lstm_probe.py (kernel
//       :71, _variant_kernel(mode).call :97), which splits a step's cost into
//       its parts. Four modes behind one entry: "full" (lstm_f32h's
//       arithmetic and instantiation), "h_bf16" (lstm_bf16h's), "gates_only"
//       (gates = xp[:, t]: no staging of h, no contraction, no reduction and
//       no shared memory, all removed at compile time; W is never read) and
//       "matmul_only" (gates as in "full", then h = the pre-activation i
//       columns, c untouched: the gate math removed). "matmul_only" uses one
//       gate's sums only, so the other three are stored to a (B, 4H) scratch
//       row of the caller's: the compiler must keep all four contractions,
//       and the mode times the whole (B, H) x (H, 4H) product as the TPU
//       kernel computes it.
// Per step:  gates = xp[:, t] + h_{t-1} . W_hh   (gate order [i, f, g, o])
//            c = sig(f) c + sig(i) tanh(g);  h = sig(o) tanh(c);  y[:, t] = h
//
// Numerics, as the TPU kernels define them:
//  - f32h (and fwd_train): h stays fp32; W_hh is the bf16-ROUNDED weight widened to fp32;
//    fp32 accumulation. An fp32 x bf16 product has no tensor-core form, so
//    this runs as fp32 FMA on the CUDA cores.
//  - bf16h: h is rounded to bf16 (round-to-nearest-even, as astype) before
//    the dot; a bf16 x bf16 product is exact in fp32, accumulated in fp32.
//  - int8: qh = rint(127 h) (half to even, as jnp.round) packed four to a
//    word; acc = qh . Wq with __dp4a into int32 (exact);
//    gates = xp + float(acc) * (w_scale / 127).
//  - expf / tanhf and explicit _rn arithmetic, no fast math, so the kernel
//    stays within a few ulp of the plain PyTorch version.
//
// What bounds it on an H100: at B=64, H=1024 a step is 2*B*H*4H = 0.54 GFLOP
// against an 8 MB (bf16) or 4 MB (int8) weight. The f32h variant is bound by
// fp32 CUDA-core FMA; the weight is re-read from L2 (it fits the 50 MB L2)
// by every batch tile each step, and the step boundary is a kernel launch.
// Design against that: each block owns JT hidden units and ALL four gate
// columns of each, for a BT-row batch tile, so the recurrent product and the
// gate math fuse in one block and no pre-activation goes to device memory;
// the block's warps split the contraction and reduce through shared memory.
// h_{t-1} is read straight from y[:, t-1] (step t writes only y[:, t], so
// blocks never race) and c is updated in place by the thread that owns it.
// A weight-stationary persistent kernel (W slice resident in shared memory,
// a barrier per step) is the faster design: lstm_persistent.cu has it for
// the training forward, which comes here only at shapes outside its plan.
// fwd_train writes 5 more floats per cell and step (c_t and four gates):
// at the training shape (B=16, T=512, H=1024) 168 MB more, still far below
// its 2*B*T*H*4H operations at the fp32 CUDA-core rate.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int JT = 32;  // hidden units per block: one per lane
constexpr int BT = 8;   // batch rows per block
constexpr int NW = 8;   // warps per block; they split the contraction

enum Mode { kF32H = 0, kBf16H = 1, kInt8 = 2, kF32HTrain = 3, kGatesOnly = 4,
            kMatmulOnly = 5 };

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// One time step. xp / y / h_in point at row 0 of step t (t-1 for h_in);
// *_row are the strides between batch rows, in elements. kF32HTrain also
// stores c_t at c_seq (rows of y_row) and the activated gates at g_seq
// (rows of xp_row); kMatmulOnly stores its three unused pre-activations at
// g_seq as a (B, 4H) scratch; the other modes get null pointers there.
template <int MODE>
__global__ void __launch_bounds__(NW * 32)
lstm_step_kernel(const float* __restrict__ xp, long long xp_row,
                 const void* __restrict__ w, const float* __restrict__ ws,
                 const float* __restrict__ h_in, long long h_row,
                 float* __restrict__ c, float* __restrict__ y, long long y_row,
                 float* __restrict__ c_seq, float* __restrict__ g_seq,
                 int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * JT + lane;
  const int b0 = blockIdx.y * BT;
  const int H4 = 4 * H;

  typedef typename std::conditional<MODE == kInt8, int, float>::type acc_t;
  acc_t* red = reinterpret_cast<acc_t*>(smem);
  if (MODE != kGatesOnly) {  // compile-time: gates_only keeps none of 1-3

  // 1. Stage this batch tile's h in shared memory, k-major ([k][bt]).
  if (MODE == kInt8) {
    int32_t* hq = reinterpret_cast<int32_t*>(smem);
    const int K4 = H >> 2;
    for (int idx = threadIdx.x; idx < BT * K4; idx += blockDim.x) {
      const int bt = idx / K4, k4 = idx - bt * K4, b = b0 + bt;
      uint32_t word = 0;
      if (b < B) {
        const float* src = h_in + b * h_row + 4 * k4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = __float2int_rn(__fmul_rn(src[e], 127.0f));
          word |= (uint32_t)(q & 0xff) << (8 * e);
        }
      }
      hq[k4 * BT + bt] = (int32_t)word;
    }
  } else {
    float* hs = reinterpret_cast<float*>(smem);
    for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
      const int bt = idx / H, k = idx - bt * H, b = b0 + bt;
      float v = b < B ? h_in[b * h_row + k] : 0.0f;
      if (MODE == kBf16H) v = __bfloat162float(__float2bfloat16_rn(v));
      hs[k * BT + bt] = v;
    }
  }
  __syncthreads();

  // 2. Partial contraction over this warp's k slice, four gate columns.
  acc_t acc[BT][4];
#pragma unroll
  for (int bt = 0; bt < BT; ++bt)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[bt][g] = 0;

  if (j < H) {
    if (MODE == kInt8) {
      const int32_t* hq = reinterpret_cast<const int32_t*>(smem);
      const int32_t* wp = static_cast<const int32_t*>(w);  // (H/4, 4H) words
      const int K4 = H >> 2;
      const int per = (K4 + NW - 1) / NW;
      const int kb = warp * per, ke = min(K4, kb + per);
      // unrolled so the weight loads of several k are in flight at once:
      // one L2 round trip per k would otherwise bound the loop
#pragma unroll 8
      for (int k4 = kb; k4 < ke; ++k4) {
        int wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) wv[g] = wp[(long long)k4 * H4 + g * H + j];
        const int4* hv4 = reinterpret_cast<const int4*>(hq + k4 * BT);
        int hv[BT];
#pragma unroll
        for (int q = 0; q < BT / 4; ++q) {
          const int4 v = hv4[q];
          hv[4 * q] = v.x; hv[4 * q + 1] = v.y; hv[4 * q + 2] = v.z; hv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int bt = 0; bt < BT; ++bt)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[bt][g] = __dp4a(hv[bt], wv[g], (int)acc[bt][g]);
      }
    } else {
      const float* hs = reinterpret_cast<const float*>(smem);
      const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);  // (H, 4H)
      const int per = (H + NW - 1) / NW;
      const int kb = warp * per, ke = min(H, kb + per);
#pragma unroll 8
      for (int k = kb; k < ke; ++k) {
        float wv[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wv[g] = __bfloat162float(wb[(long long)k * H4 + g * H + j]);
        const float4* hv4 = reinterpret_cast<const float4*>(hs + k * BT);
        float hv[BT];
#pragma unroll
        for (int q = 0; q < BT / 4; ++q) {
          const float4 v = hv4[q];
          hv[4 * q] = v.x; hv[4 * q + 1] = v.y; hv[4 * q + 2] = v.z; hv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int bt = 0; bt < BT; ++bt)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            acc[bt][g] = __fmaf_rn(hv[bt], wv[g], acc[bt][g]);
      }
    }
  }
  __syncthreads();  // every warp is done with the staged h

  // 3. Reduce the warps' partials through shared memory: red[w][bt][g][lane].
#pragma unroll
  for (int bt = 0; bt < BT; ++bt)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      red[((warp * BT + bt) * 4 + g) * 32 + lane] = acc[bt][g];
  __syncthreads();

  }  // MODE != kGatesOnly

  // 4. Gate math for (bt, lane) pairs; each cell has exactly one owner.
  for (int o = threadIdx.x; o < BT * 32; o += blockDim.x) {
    const int bt = o >> 5, l = o & 31;
    const int b = b0 + bt, jj = blockIdx.x * JT + l;
    if (b >= B || jj >= H) continue;
    float gate[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      acc_t s = 0;
      if (MODE != kGatesOnly)
        for (int wi = 0; wi < NW; ++wi) s += red[((wi * BT + bt) * 4 + g) * 32 + l];
      const float x = xp[b * xp_row + g * H + jj];
      if (MODE == kGatesOnly)
        gate[g] = x;
      else if (MODE == kInt8)
        gate[g] = __fadd_rn(x, __fmul_rn((float)s, ws[g * H + jj]));
      else
        gate[g] = __fadd_rn(x, (float)s);
    }
    if (MODE == kMatmulOnly) {
      // h = gates[:, :H]; c stays. The three other sums go to the scratch
      // so that their contractions are not dead code.
      y[b * y_row + jj] = gate[0];
      float* sink = g_seq + (long long)b * H4 + jj;
      sink[H] = gate[1];
      sink[2 * H] = gate[2];
      sink[3 * H] = gate[3];
      continue;
    }
    const float ig = sigmoid_rn(gate[0]);
    const float fg = sigmoid_rn(gate[1]);
    const float gg = tanhf(gate[2]);
    const float og = sigmoid_rn(gate[3]);
    const long long cidx = (long long)b * H + jj;
    const float cn = __fadd_rn(__fmul_rn(fg, c[cidx]), __fmul_rn(ig, gg));
    c[cidx] = cn;
    y[b * y_row + jj] = __fmul_rn(og, tanhf(cn));
    if (MODE == kF32HTrain) {
      c_seq[b * y_row + jj] = cn;
      float* gp = g_seq + b * xp_row + jj;
      gp[0] = ig;
      gp[H] = fg;
      gp[2 * H] = gg;
      gp[3 * H] = og;
    }
  }
}

template <int MODE>
int run_layer(const float* xp, const void* w, const float* ws, const float* h0,
              float* c, float* y, float* c_seq, float* g_seq, int B, int T, int H,
              cudaStream_t stream) {
  const size_t stage = MODE == kInt8 ? (size_t)BT * (H / 4) * 4 : (size_t)BT * H * 4;
  const size_t reduce = (size_t)NW * BT * 4 * 32 * 4;
  const size_t smem = MODE == kGatesOnly ? 0 : stage > reduce ? stage : reduce;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_step_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + JT - 1) / JT, (B + BT - 1) / BT);
  const long long xp_row = (long long)T * 4 * H, y_row = (long long)T * H;
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : y + (size_t)(t - 1) * H;
    const long long h_row = t == 0 ? (long long)H : y_row;
    lstm_step_kernel<MODE><<<grid, NW * 32, smem, stream>>>(
        xp + (size_t)t * 4 * H, xp_row, w, ws, h_in, h_row, c,
        y + (size_t)t * H, y_row,
        MODE == kF32HTrain ? c_seq + (size_t)t * H : nullptr,
        MODE == kF32HTrain ? g_seq + (size_t)t * 4 * H
                           : MODE == kMatmulOnly ? g_seq : nullptr,
        B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// xp (B, T, 4H) f32; w (H, 4H) bf16; h0 (B, H) f32; c (B, H) f32 holds c0 on
// entry and c_T on return; y (B, T, H) f32. Launches T kernels; returns the
// first cudaGetLastError() that is not cudaSuccess, else 0.
extern "C" int lstm_f32h(const float* xp, const void* w, const float* h0, float* c,
                         float* y, int B, int T, int H, void* stream) {
  return run_layer<kF32H>(xp, w, nullptr, h0, c, y, nullptr, nullptr, B, T, H,
                         (cudaStream_t)stream);
}

extern "C" int lstm_bf16h(const float* xp, const void* w, const float* h0, float* c,
                          float* y, int B, int T, int H, void* stream) {
  return run_layer<kBf16H>(xp, w, nullptr, h0, c, y, nullptr, nullptr, B, T, H,
                          (cudaStream_t)stream);
}

// wq: (H/4, 4H) int32 words, byte e of word [k4, n] = Wq[4 k4 + e, n];
// ws (4H,) f32 = w_scale / 127.
extern "C" int lstm_int8(const float* xp, const void* wq, const float* ws,
                         const float* h0, float* c, float* y, int B, int T, int H,
                         void* stream) {
  return run_layer<kInt8>(xp, wq, ws, h0, c, y, nullptr, nullptr, B, T, H,
                         (cudaStream_t)stream);
}

// lstm_f32h that also writes c_seq (B, T, H) f32 (c_t of every step) and
// gates (B, T, 4H) f32 (sig(i), sig(f), tanh(g), sig(o) of every step).
extern "C" int lstm_fwd_train_f32h(const float* xp, const void* w, const float* h0,
                                   float* c, float* y, float* c_seq, float* gates,
                                   int B, int T, int H, void* stream) {
  return run_layer<kF32HTrain>(xp, w, nullptr, h0, c, y, c_seq, gates, B, T, H,
                               (cudaStream_t)stream);
}

// The probe (scripts/bench_lstm_probe.py): lstm_f32h's arguments, a (B, 4H)
// f32 scratch that only mode 3 writes, and mode 0 "full", 1 "h_bf16",
// 2 "gates_only" (w is not read), 3 "matmul_only" (c is not touched).
extern "C" int lstm_probe(const float* xp, const void* w, const float* h0, float* c,
                          float* y, float* scratch, int B, int T, int H, int mode,
                          void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return run_layer<kF32H>(xp, w, nullptr, h0, c, y, nullptr, nullptr, B, T, H, s);
    case 1:
      return run_layer<kBf16H>(xp, w, nullptr, h0, c, y, nullptr, nullptr, B, T, H, s);
    case 2:
      return run_layer<kGatesOnly>(xp, w, nullptr, h0, c, y, nullptr, nullptr, B, T, H, s);
    case 3:
      return run_layer<kMatmulOnly>(xp, w, nullptr, h0, c, y, nullptr, scratch, B, T, H, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
