// LSTM backward recurrence for Hopper (sm_90a): one kernel launch per time
// step in reverse time, driven by a host loop on the caller's stream.
//
// Replaces avvad_tpu/ops/lstm_pallas.py _lstm_bwd_kernel via _bwd_call:
//   lstm_bwd_f32h <- the reverse-time gradient recurrence of one layer.
// Its forward partner is lstm_fwd_train_f32h (lstm_recurrence.cu), which
// leaves the residuals read here: c_t and the post-activation gates
// [i, f, g, o] of every step. Per step t, from T-1 down to 0:
//   dh   = dy[:, t] + d_gates[:, t+1] . W^T        (0 for the second term at T-1)
//   do   = dh tanh(c_t)
//   dc   = dh o (1 - tanh(c_t)^2) + dc_{t+1}
//   d_gates[:, t] = [dc g i(1-i), dc c_{t-1} f(1-f), dc i (1-g^2), do o(1-o)]
//   dc_t = dc f
// and after step 0 one contraction-only launch: dh0 = d_gates[:, 0] . W^T;
// dc0 is the dc left in place. dW_hh = h_prev^T d_gates and the x_proj
// cotangent (d_gates itself) are left to the caller, as the JAX package
// leaves them to XLA.
//
// Numerics, as the TPU kernel defines them: W^T (4H, H) is the bf16-rounded
// weight (jnp.transpose(w_hh).astype(bf16)) widened to fp32, d_gates fp32,
// fp32 FMA accumulation; tanhf and explicit _rn arithmetic in the order of
// the Pallas kernel, no fast math, so the kernel stays within a few ulp of
// the plain PyTorch version.
//
// What bounds it on an H100: at B=16, H=1024 a step's contraction is
// 2*B*4H*H = 0.13 GFLOP against the 8 MB bf16 W^T, on the fp32 CUDA cores
// (an fp32 x bf16 product has no tensor-core form): over T steps the same
// 2*B*T*H*4H operations as the forward. Design: each block owns JT hidden
// units for a BT-row batch tile; it stages d_gates[:, t+1] of its rows in
// shared memory in k-chunks of KC columns ([k][bt], so one float4 pair
// serves the 8 rows), each lane reads W^T[k, j] for its own unit (lanes
// over j: coalesced), the warps split each chunk's k range and reduce
// through shared memory, then the owner of (b, j) runs the elementwise
// backward and writes its four gate gradients. Step t reads d_gates[:, t+1]
// and writes only d_gates[:, t], so blocks never race; dc is updated in
// place by the thread that owns it. A persistent kernel with W^T resident
// in shared memory (grid-wide barrier per step) is the later, faster design.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int JT = 32;    // hidden units per block: one per lane
constexpr int BT = 8;     // batch rows per block
constexpr int NW = 8;     // warps per block; they split the contraction
constexpr int KC = 1024;  // d_gates columns staged per pass: BT * KC * 4 = 32 KB

// One reverse step. dg_next: d_gates at t+1 (row 0; null at t = T-1, where
// the recurrent term is 0); wt: W^T (4H, H) bf16. With ELEM the pointers
// dy / c / c_prev (rows of h_row) and gates / dg_out (rows of g_row) are at
// step t, and the block writes dg_out and updates dc; without ELEM it only
// writes dh_out[b, j] = dg_next[b] . W^T[:, j] (the dh0 launch).
template <bool ELEM>
__global__ void __launch_bounds__(NW * 32)
lstm_bwd_step_kernel(const float* __restrict__ dg_next, long long g_row,
                     const __nv_bfloat16* __restrict__ wt,
                     const float* __restrict__ dy, const float* __restrict__ gates,
                     const float* __restrict__ c, const float* __restrict__ c_prev,
                     long long h_row, float* __restrict__ dc,
                     float* __restrict__ dg_out, float* __restrict__ dh_out,
                     int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = blockIdx.x * JT + lane;
  const int b0 = blockIdx.y * BT;
  const int H4 = 4 * H;

  // 1. dh_rec[bt] = sum_k dg_next[b0 + bt, k] W^T[k, j], this warp's k slices.
  float acc[BT];
#pragma unroll
  for (int bt = 0; bt < BT; ++bt) acc[bt] = 0.0f;
  if (dg_next != nullptr) {  // uniform over the block
    for (int k0 = 0; k0 < H4; k0 += KC) {
      const int kn = min(KC, H4 - k0);
      __syncthreads();  // every warp is done with the previous chunk
      for (int idx = threadIdx.x; idx < BT * kn; idx += blockDim.x) {
        const int bt = idx / kn, k = idx - bt * kn, b = b0 + bt;
        stage[k * BT + bt] = b < B ? dg_next[b * g_row + k0 + k] : 0.0f;
      }
      __syncthreads();
      if (j < H) {
        const int per = (kn + NW - 1) / NW;
        const int kb = warp * per, ke = min(kn, kb + per);
#pragma unroll 8
        for (int k = kb; k < ke; ++k) {
          const float wv = __bfloat162float(wt[(long long)(k0 + k) * H + j]);
          const float4* dv4 = reinterpret_cast<const float4*>(stage + k * BT);
          float dv[BT];
#pragma unroll
          for (int q = 0; q < BT / 4; ++q) {
            const float4 v = dv4[q];
            dv[4 * q] = v.x; dv[4 * q + 1] = v.y; dv[4 * q + 2] = v.z; dv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int bt = 0; bt < BT; ++bt) acc[bt] = __fmaf_rn(dv[bt], wv, acc[bt]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the staged chunk

  // 2. Reduce the warps' partials through shared memory: red[w][bt][lane].
  float* red = stage;
#pragma unroll
  for (int bt = 0; bt < BT; ++bt) red[(warp * BT + bt) * 32 + lane] = acc[bt];
  __syncthreads();

  // 3. Elementwise backward for (bt, lane) pairs; each cell has one owner.
  for (int o = threadIdx.x; o < BT * 32; o += blockDim.x) {
    const int bt = o >> 5, l = o & 31;
    const int b = b0 + bt, jj = blockIdx.x * JT + l;
    if (b >= B || jj >= H) continue;
    float dh_rec = 0.0f;
    for (int wi = 0; wi < NW; ++wi) dh_rec += red[(wi * BT + bt) * 32 + l];
    const long long sidx = (long long)b * H + jj;
    if (!ELEM) {
      dh_out[sidx] = dh_rec;
      continue;
    }
    const long long hidx = b * h_row + jj;
    const float* gp = gates + b * g_row + jj;
    const float ig = gp[0], fg = gp[H], gg = gp[2 * H], og = gp[3 * H];
    const float tc = tanhf(c[hidx]);
    const float dh = __fadd_rn(dy[hidx], dh_rec);
    const float d_o = __fmul_rn(dh, tc);
    const float dcv = __fadd_rn(
        __fmul_rn(__fmul_rn(dh, og), __fsub_rn(1.0f, __fmul_rn(tc, tc))), dc[sidx]);
    const float di = __fmul_rn(dcv, gg);
    const float df = __fmul_rn(dcv, c_prev[hidx]);
    const float dg = __fmul_rn(dcv, ig);
    float* op = dg_out + b * g_row + jj;
    op[0] = __fmul_rn(__fmul_rn(di, ig), __fsub_rn(1.0f, ig));
    op[H] = __fmul_rn(__fmul_rn(df, fg), __fsub_rn(1.0f, fg));
    op[2 * H] = __fmul_rn(dg, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
    op[3 * H] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
    dc[sidx] = __fmul_rn(dcv, fg);
  }
}

}  // namespace

// dy, c_seq, c_prev (B, T, H) f32; gates (B, T, 4H) f32 (activated, from
// lstm_fwd_train_f32h); wt (4H, H) bf16 = W_hh^T; d_gates (B, T, 4H) f32 out;
// dh0 (B, H) f32 out; dc (B, H) f32 holds zeros on entry and dc0 on return.
// Launches T + 1 kernels (T >= 1); returns the first cudaGetLastError() that
// is not cudaSuccess, else 0.
extern "C" int lstm_bwd_f32h(const float* dy, const float* gates, const float* c_seq,
                             const float* c_prev, const void* wt, float* d_gates,
                             float* dh0, float* dc, int B, int T, int H,
                             void* stream) {
  const size_t stage = (size_t)BT * KC * 4;
  const size_t reduce = (size_t)NW * BT * 32 * 4;
  const size_t smem = stage > reduce ? stage : reduce;  // 32 KB: no opt-in
  const dim3 grid((H + JT - 1) / JT, (B + BT - 1) / BT);
  const long long g_row = (long long)T * 4 * H, h_row = (long long)T * H;
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(wt);
  cudaStream_t s = (cudaStream_t)stream;
  for (int t = T - 1; t >= 0; --t) {
    const float* dg_next = t == T - 1 ? nullptr : d_gates + (size_t)(t + 1) * 4 * H;
    lstm_bwd_step_kernel<true><<<grid, NW * 32, smem, s>>>(
        dg_next, g_row, w, dy + (size_t)t * H, gates + (size_t)t * 4 * H,
        c_seq + (size_t)t * H, c_prev + (size_t)t * H, h_row, dc,
        d_gates + (size_t)t * 4 * H, nullptr, B, H);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  lstm_bwd_step_kernel<false><<<grid, NW * 32, smem, s>>>(
      d_gates, g_row, w, nullptr, nullptr, nullptr, nullptr, h_row, dc, nullptr,
      dh0, B, H);
  return (int)cudaGetLastError();
}
