// The two training recurrences of one LSTM layer as persistent,
// weight-stationary kernels for Hopper (sm_90a): ONE cooperative launch per
// layer and sequence; the time loop runs inside the kernel.
//
// Replaces, at the shapes the plan takes (H % 4 == 0, ceil(H / 16) CTAs
// co-resident, one an SM, and their shared memory within the limit: H <= 1100
// at B=16 on a 132-SM card), the TPU kernels of avvad_tpu/ops/lstm_pallas.py:
//   lstm_fwd_train_persist <- _lstm_fwd_train_kernel (:116) via _fwd_train_call (:279)
//   lstm_bwd_persist       <- _lstm_bwd_kernel (:138) via _bwd_call (:314)
// The Pallas kernels carry h, c, dh and dc in scratch across a sequential
// grid; here a CTA carries them across a loop. Outside the plan the wrapper
// routes to the per-step kernels lstm_fwd_train_f32h (lstm_recurrence.cu)
// and lstm_bwd_f32h (lstm_train.cu), which compute the same function.
//
// What they compute (the arithmetic and its order are the per-step
// kernels'): per forward step  gates = xp[:, t] + h_{t-1} . W_hh  (order
// [i, f, g, o]), c = sig(f) c + sig(i) tanh(g), h = sig(o) tanh(c), with
// y[:, t] = h, c_seq[:, t] = c and the activated gates stored; per reverse
// step  dh = dy[:, t] + d_gates[:, t+1] . W^T, then the elementwise
// backward of lstm_train.cu, d_gates[:, t] stored; after step 0,
// dh0 = d_gates[:, 0] . W^T in the same launch. h and d_gates stay fp32,
// the weight is the bf16-rounded one widened to fp32, fp32 FMA
// accumulation, expf / tanhf and _rn arithmetic, no fast math.
//
// What bounds them on an H100: 2*B*T*H*4H operations on the fp32 CUDA cores
// (an fp32 x bf16 product has no tensor-core form): 1.03 ms at B=16, T=512,
// H=1024 and 67 TFLOP/s, 2.0 us a step; the bytes (x_proj, the residuals,
// the outputs, each once) are a tenth of that. The per-step kernels miss it
// by 15x and 30x because every step is a cold launch of 64 blocks that pull
// the 8 MB weight through L2 again and stage their operand as a chain of
// scalar loads. Design against that:
//  - The grid is unit slices x row slices. A CTA owns 16 hidden units, with
//    all 4 gate columns of each (forward) or its 16 columns of W^T
//    (backward), for the whole sequence: that slice, H x 64 or 4H x 16 bf16
//    = 128 KB at H=1024, is loaded once and stays in shared memory; the
//    weight is never read again. The batch is cut into tiles of 8 rows,
//    dealt round-robin to as many row slices as the card holds beside each
//    other: 64 x 2 = 128 CTAs on 132 SMs at B=16, H=1024. Splitting rows
//    rather than units halves what the exchange pulls through L2, because a
//    CTA needs the whole h or d_gates row of its own batch rows only.
//  - c (forward) and dc (backward) of the CTA's cells stay in shared memory
//    from the first step to the last.
//  - The steps are separated by a barrier over the CTAs of a row slice (rows
//    are independent recurrences): a monotone counter in global memory
//    (fence and add by one thread after __syncthreads, spin and fence by one
//    thread). The launch is cooperative, so a grid that cannot be
//    co-resident is refused instead of deadlocking, and the C entry checks
//    the occupancy first.
//  - The exchange goes through the outputs themselves: step t reads 8 rows
//    of y[:, t-1] (32 KB) or of d_gates[:, t+1] (128 KB), which other SMs
//    wrote in this launch, so they are read with cp.async.cg (L2 only,
//    never the incoherent L1), 16 bytes a thread, into a ring of three
//    512-column chunks; the contraction of one chunk overlaps the loads of
//    the next two. Rows are padded by 8 floats so that the float4 reads of
//    the contraction do not conflict.
//  - The contraction is register-tiled: a thread holds a 4-row x 8-column
//    accumulator tile, so each 16-byte weight read (8 bf16) serves 4 rows
//    and each float4 of h serves 8 columns: 128 FMAs per 8 shared-memory
//    loads. k is split over "k-groups" of 16 (forward) or 4 (backward)
//    threads, 16 or 64 a CTA, each taking every 16th or 64th group of four
//    k; the weight slice is stored [k % 4][k / 4][column], which makes the
//    reads of the k-groups of a warp contiguous. Partials go once a step
//    through shared memory to the thread that owns the cell, which sums
//    them in a fixed order (the result does not change from run to run),
//    does the gate math and writes the outputs.
// Not taken here: a 2- or 4-CTA cluster with a multicast load would divide
// again the 4 MB (forward) or 16 MB (backward) a step that 128 CTAs pull
// through L2; it needs TMA descriptors, mbarriers and cluster launch
// attributes on top of a cooperative launch. What is left of a step beside
// the FMAs is a chain that nothing overlaps yet: the stores of the
// exchange, the barrier, the first chunk's way back from L2. Tiles of 4
// rows, two a CTA, each with a barrier of its own, so that one tile's chain
// would run under the other's FMAs, were slower on the card: every tile
// pays its own fence and its own way to L2 and back, one after the other.
// Overlapping them takes a warp of its own that polls and loads ahead.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int U = 16;       // hidden units per CTA
constexpr int BT = 8;       // batch rows per tile
constexpr int NT = 256;     // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int KC = 512;     // contraction columns per ring chunk
constexpr int NSTAGE = 3;   // ring chunks
constexpr int ASTRIDE = KC + 8;  // floats between the rows of a chunk
constexpr int RING_FLOATS = NSTAGE * BT * ASTRIDE;

// Geometry of a contraction whose output tile is 8 rows x 8*NCG columns: a
// k-group is 2 x NCG threads, each with 4 rows x 8 columns.
template <int NCG>
struct Tile {
  static constexpr int NCOL = 8 * NCG;
  static constexpr int QPW = 16 / NCG;     // k-groups per warp
  static constexpr int KG = NWARP * QPW;   // k-groups per CTA
  // floats between the rows of a k-group's partials; padded by half the 32
  // banks where a row is a multiple of them: a warp of cell threads reads
  // two rows
  static constexpr int RS = NCOL % 32 == 0 ? NCOL + 16 : NCOL;
  static constexpr int RED_FLOATS = KG * BT * RS;
};

__device__ __forceinline__ float sigmoid_rn(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Barrier over the CTAs of a row slice, on a counter that only grows;
// `target` is the number of arrivals that completes this round. The writes
// of every thread of the CTA are ordered before the add by __syncthreads
// and the fence (cumulative), and the reads after the spin by the fence and
// __syncthreads.
__device__ __forceinline__ void grid_arrive(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
  }
}

__device__ __forceinline__ void grid_wait(unsigned* bar, unsigned target) {
  if (threadIdx.x == 0) {
    while (*reinterpret_cast<volatile unsigned*>(bar) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// acc[i][c] = sum_k A[b0 + rq + 2 i, k] * W[k, 8 cq + c] over this thread's
// k-group. A: K floats a row at src + b * row_stride, written by other SMs
// in this launch: streamed through the ring with cp.async.cg. W: the CTA's
// slice in shared memory, [k % 4][k / 4][NCOL] bf16. Every thread of the
// CTA calls this. Rows b >= B of the ring are not written: they keep zeros
// or an earlier tile's values, and the sums of those rows are never used.
template <int NCG>
__device__ __forceinline__ void stream_contract(const float* src, long long row_stride,
                                                int b0, int B, int K,
                                                const __nv_bfloat16* wsm, float* ring,
                                                float (&acc)[4][8]) {
  typedef Tile<NCG> TL;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cq = lane % NCG, rq = (lane / NCG) & 1;
  const int q = warp * TL::QPW + lane / (2 * NCG);
  const int Kq = K >> 2;
  const int nchunk = (K + KC - 1) / KC;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.0f;

  // a thread copies one 16-byte granule column of every second row: 128
  // threads cover a row of a chunk, contiguous in global memory
  const int ig = tid % (KC / 4), ir = tid / (KC / 4);
  auto fetch = [&](int chunk) {
    const int k0 = chunk * KC;
    if (chunk < nchunk && 4 * ig < K - k0) {
      float* dst = ring + (chunk % NSTAGE) * (BT * ASTRIDE) + ir * ASTRIDE + 4 * ig;
      const float* from = src + (long long)(b0 + ir) * row_stride + k0 + 4 * ig;
#pragma unroll
      for (int row = ir; row < BT; row += NT / (KC / 4)) {
        if (b0 + row < B) cp_async16(dst, from);
        dst += (NT / (KC / 4)) * ASTRIDE;
        from += (NT / (KC / 4)) * row_stride;
      }
    }
    cp_async_commit();  // an empty group keeps the count uniform
  };

  fetch(0);
  fetch(1);
  for (int chunk = 0; chunk < nchunk; ++chunk) {
    cp_async_wait<1>();  // this thread's part of `chunk` has landed
    __syncthreads();     // everyone's has; everyone is done with chunk - 1
    fetch(chunk + 2);    // into the slot of chunk - 1
    const int k0 = chunk * KC;
    const int ng = min(KC, K - k0) >> 2;
    const float* a_base = ring + (chunk % NSTAGE) * (BT * ASTRIDE) + rq * ASTRIDE;
    const __nv_bfloat16* w_base = wsm + (size_t)(k0 >> 2) * TL::NCOL + cq * 8;
#pragma unroll(NCG == 8 ? 4 : 1)
    for (int gl = q; gl < ng; gl += TL::KG) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_base + 2 * i * ASTRIDE + 4 * gl);
      const __nv_bfloat16* wp = w_base + (size_t)gl * TL::NCOL;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint4 wv =
            *reinterpret_cast<const uint4*>(wp + (size_t)kk * Kq * TL::NCOL);
        const unsigned wu[4] = {wv.x, wv.y, wv.z, wv.w};
        float w[8];
#pragma unroll
        for (int p = 0; p < 4; ++p) {  // bf16 -> fp32 is a shift into the high half
          w[2 * p] = __uint_as_float(wu[p] << 16);
          w[2 * p + 1] = __uint_as_float(wu[p] & 0xffff0000u);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[i][c] = __fmaf_rn(av, w[c], acc[i][c]);
        }
      }
    }
  }
}

// The k-group's partials into red[q][row][column].
template <int NCG>
__device__ __forceinline__ void store_partials(float* red, const float (&acc)[4][8]) {
  typedef Tile<NCG> TL;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cq = lane % NCG, rq = (lane / NCG) & 1;
  const int q = warp * TL::QPW + lane / (2 * NCG);
  float* r = red + q * (BT * TL::RS) + cq * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4* p = reinterpret_cast<float4*>(r + (rq + 2 * i) * TL::RS);
    p[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    p[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

// Forward: CTA (x, r) owns hidden units [16 x, 16 x + 16) of the batch tiles
// r, r + gridDim.y, ... Shared memory: W slice (H x 64 bf16), ring, partials,
// c of the CTA's cells.
__global__ void __launch_bounds__(NT, 1)
lstm_fwd_persist_kernel(const float* __restrict__ xp, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ h0, float* c, float* y,
                        float* __restrict__ c_seq, float* __restrict__ gates,
                        unsigned* bar, int B, int T, int H) {
  typedef Tile<8> TL;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ring = reinterpret_cast<float*>(smem + (size_t)H * TL::NCOL * 2);
  float* red = ring + RING_FLOATS;
  float* cst = red + TL::RED_FLOATS;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * U;
  const int H4 = 4 * H, Kq = H >> 2;

  // W[k, g H + j0 + u] -> slot [k % 4][k / 4], column g U + u; 4 bf16 a load
  for (int idx = tid; idx < H * 16; idx += NT) {
    const int k = idx >> 4, p = idx & 15, g = p >> 2, u4 = (p & 3) * 4;
    uint2 v = make_uint2(0u, 0u);
    if (j0 + u4 < H)
      v = __ldg(reinterpret_cast<const uint2*>(w + (size_t)k * H4 + g * H + j0 + u4));
    const int slot = (k & 3) * Kq + (k >> 2);
    *reinterpret_cast<uint2*>(wsm + (size_t)slot * TL::NCOL + g * U + u4) = v;
  }
  for (int i = tid; i < RING_FLOATS; i += NT) ring[i] = 0.0f;
  const int row = tid / U, u = tid % U, j = j0 + u;
  const int tile0 = BT * blockIdx.y, tile_step = BT * gridDim.y;
  // cell (b0 + row, j) of the CTA's m-th tile keeps its c at cst[m][row][u]
  if (tid < BT * U) {
    for (int m = 0, b0 = tile0; b0 < B; ++m, b0 += tile_step)
      cst[m * (BT * U) + tid] = b0 + row < B && j < H ? c[(size_t)(b0 + row) * H + j] : 0.0f;
  }
  __syncthreads();

  const long long xrow = (long long)T * H4, yrow = (long long)T * H;
  unsigned* my_bar = bar + blockIdx.y;  // rows are independent: a barrier a row slice
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : y + (size_t)(t - 1) * H;
    const long long h_row = t == 0 ? (long long)H : yrow;
    for (int m = 0, b0 = tile0; b0 < B; ++m, b0 += tile_step) {
      const int b = b0 + row;
      const bool cell = tid < BT * U && b < B && j < H;
      float* cell_c = cst + m * (BT * U) + tid;
      float x[4];
      if (cell) {  // in flight during the contraction
#pragma unroll
        for (int g = 0; g < 4; ++g) x[g] = __ldg(xp + b * xrow + (size_t)t * H4 + g * H + j);
      }
      float acc[4][8];
      stream_contract<8>(h_in, h_row, b0, B, H, wsm, ring, acc);
      store_partials<8>(red, acc);
      __syncthreads();
      if (cell) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.0f;
          for (int qi = 0; qi < TL::KG; ++qi)
            s += red[qi * (BT * TL::RS) + row * TL::RS + g * U + u];
          gate[g] = __fadd_rn(x[g], s);
        }
        const float ig = sigmoid_rn(gate[0]);
        const float fg = sigmoid_rn(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoid_rn(gate[3]);
        const float cn = __fadd_rn(__fmul_rn(fg, *cell_c), __fmul_rn(ig, gg));
        *cell_c = cn;
        y[b * yrow + (size_t)t * H + j] = __fmul_rn(og, tanhf(cn));  // the exchange: first
        c_seq[b * yrow + (size_t)t * H + j] = cn;
        float* gp = gates + b * xrow + (size_t)t * H4 + j;
        gp[0] = ig;
        gp[H] = fg;
        gp[2 * H] = gg;
        gp[3 * H] = og;
      }
    }
    if (t + 1 < T) {  // y[rows, t] complete on every CTA of the slice before it is read
      grid_arrive(my_bar);
      grid_wait(my_bar, gridDim.x * (unsigned)(t + 1));
    }
  }
  if (tid < BT * U && j < H) {
    for (int m = 0, b0 = tile0; b0 + row < B; ++m, b0 += tile_step)
      c[(size_t)(b0 + row) * H + j] = cst[m * (BT * U) + tid];
  }
}

// Backward: CTA (x, r) owns hidden units [16 x, 16 x + 16) of the batch
// tiles r, r + gridDim.y, ... Shared memory: W^T slice (4H x 16 bf16), ring,
// partials, dc of its cells.
__global__ void __launch_bounds__(NT, 1)
lstm_bwd_persist_kernel(const float* __restrict__ dy, const float* __restrict__ gates,
                        const float* __restrict__ c_seq, const float* __restrict__ c_prev,
                        const __nv_bfloat16* __restrict__ wt, float* dg,
                        float* __restrict__ dh0, float* dc, unsigned* bar, int B, int T,
                        int H) {
  typedef Tile<2> TL;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);
  const int K = 4 * H, Kq = H;
  float* ring = reinterpret_cast<float*>(smem + (size_t)K * TL::NCOL * 2);
  float* red = ring + RING_FLOATS;
  float* dcst = red + TL::RED_FLOATS;
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * U;

  // W^T[k, j0 + u] -> slot [k % 4][k / 4], column u; 4 bf16 a load
  for (int idx = tid; idx < K * 4; idx += NT) {
    const int k = idx >> 2, u4 = (idx & 3) * 4;
    uint2 v = make_uint2(0u, 0u);
    if (j0 + u4 < H) v = __ldg(reinterpret_cast<const uint2*>(wt + (size_t)k * H + j0 + u4));
    const int slot = (k & 3) * Kq + (k >> 2);
    *reinterpret_cast<uint2*>(wsm + (size_t)slot * TL::NCOL + u4) = v;
  }
  for (int i = tid; i < RING_FLOATS; i += NT) ring[i] = 0.0f;
  const int row = tid / U, u = tid % U, j = j0 + u;
  const int tile0 = BT * blockIdx.y, tile_step = BT * gridDim.y;
  // cell (b0 + row, j) of the CTA's m-th tile keeps its dc at dcst[m][row][u]
  if (tid < BT * U) {
    for (int m = 0, b0 = tile0; b0 < B; ++m, b0 += tile_step)
      dcst[m * (BT * U) + tid] = b0 + row < B && j < H ? dc[(size_t)(b0 + row) * H + j] : 0.0f;
  }
  __syncthreads();

  const long long grow = (long long)T * K, hrow = (long long)T * H;
  unsigned* my_bar = bar + blockIdx.y;  // rows are independent: a barrier a row slice

  // dh_rec of this thread's cell from the partials of every k-group
  auto cell_sum = [&]() {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int qi = 0; qi < TL::KG; qi += 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += red[(qi + e) * (BT * TL::RS) + row * TL::RS + u];
    }
    return (s[0] + s[1]) + (s[2] + s[3]);
  };

  for (int t = T - 1; t >= 0; --t) {
    for (int m = 0, b0 = tile0; b0 < B; ++m, b0 += tile_step) {
      const int b = b0 + row;
      const bool cell = tid < BT * U && b < B && j < H;
      float* cell_dc = dcst + m * (BT * U) + tid;
      float ig = 0.0f, fg = 0.0f, gg = 0.0f, og = 0.0f, cv = 0.0f, cp = 0.0f, dyv = 0.0f;
      if (cell) {  // in flight during the contraction
        const float* gp = gates + b * grow + (size_t)t * K + j;
        ig = __ldg(gp);
        fg = __ldg(gp + H);
        gg = __ldg(gp + 2 * H);
        og = __ldg(gp + 3 * H);
        const size_t hidx = b * hrow + (size_t)t * H + j;
        cv = __ldg(c_seq + hidx);
        cp = __ldg(c_prev + hidx);
        dyv = __ldg(dy + hidx);
      }
      float dh_rec = 0.0f;
      if (t < T - 1) {  // uniform over the grid; the recurrent term is 0 at T - 1
        float acc[4][8];
        stream_contract<2>(dg + (size_t)(t + 1) * K, grow, b0, B, K, wsm, ring, acc);
        store_partials<2>(red, acc);
        __syncthreads();
        if (cell) dh_rec = cell_sum();
      }
      if (cell) {
        const float tc = tanhf(cv);
        const float dh = __fadd_rn(dyv, dh_rec);
        const float d_o = __fmul_rn(dh, tc);
        const float dcv = __fadd_rn(
            __fmul_rn(__fmul_rn(dh, og), __fsub_rn(1.0f, __fmul_rn(tc, tc))), *cell_dc);
        const float di = __fmul_rn(dcv, gg);
        const float df = __fmul_rn(dcv, cp);
        const float dgg = __fmul_rn(dcv, ig);
        float* op = dg + b * grow + (size_t)t * K + j;
        op[0] = __fmul_rn(__fmul_rn(di, ig), __fsub_rn(1.0f, ig));
        op[H] = __fmul_rn(__fmul_rn(df, fg), __fsub_rn(1.0f, fg));
        op[2 * H] = __fmul_rn(dgg, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
        op[3 * H] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
        *cell_dc = __fmul_rn(dcv, fg);
      }
    }
    // d_gates[rows, t] complete on every CTA of the slice before it is
    // read; after step 0 too, for the dh0 contraction
    grid_arrive(my_bar);
    grid_wait(my_bar, gridDim.x * (unsigned)(T - t));
  }

  for (int m = 0, b0 = tile0; b0 < B; ++m, b0 += tile_step) {  // dh0 = d_gates[:, 0] . W^T
    const int b = b0 + row;
    float acc[4][8];
    stream_contract<2>(dg, grow, b0, B, K, wsm, ring, acc);
    store_partials<2>(red, acc);
    __syncthreads();
    if (tid < BT * U && b < B && j < H) {
      dh0[(size_t)b * H + j] = cell_sum();
      dc[(size_t)b * H + j] = dcst[m * (BT * U) + tid];
    }
  }
}

// Row slices of the grid: as many as the card holds beside each other with
// one CTA an SM, at most one a batch tile; 0 if not even one fits.
int row_slices(int B, int H, int sms) {
  const int tiles = (B + BT - 1) / BT, gx = (H + U - 1) / U;
  return tiles < sms / gx ? tiles : sms / gx;
}

// Shared memory of a CTA: the weight slice (128 H bytes in both kernels),
// the ring, the partials and the state of its batch tiles.
template <int NCG>
size_t smem_bytes(int B, int slices) {
  const int tiles = ((B + BT - 1) / BT + slices - 1) / slices;
  return (size_t)(RING_FLOATS + Tile<NCG>::RED_FLOATS + tiles * BT * U) * 4;
}

// One cooperative launch of ceil(H / 16) x slices CTAs, after the occupancy
// says that they fit the card together.
template <int NCG>
int launch(const void* kernel, int B, int H, void** args, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int gx = (H + U - 1) / U, slices = row_slices(B, H, sms);
  if (slices < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t smem = (size_t)128 * H + smem_bytes<NCG>(B, slices);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) !=
      cudaSuccess)
    return (int)e;
  if ((long long)per_sm * sms < (long long)gx * slices)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(kernel, dim3(gx, slices), dim3(NT), args, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// lstm_fwd_train_f32h's arguments and `bar`, zeroed 32-bit counters in device
// memory, one a batch tile of 8 rows (a row slice uses one). One launch;
// returns the first CUDA error, else 0: a shape outside the plan (H % 4 != 0,
// a grid the card cannot hold at once, a weight slice beyond the shared
// memory) is an error, never another route.
extern "C" int lstm_fwd_train_persist(const float* xp, const void* w, const float* h0,
                                      float* c, float* y, float* c_seq, float* gates,
                                      void* bar, int B, int T, int H, void* stream) {
  if (B < 1 || T < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  unsigned* barp = static_cast<unsigned*>(bar);
  void* args[] = {&xp, &wb, &h0, &c, &y, &c_seq, &gates, &barp, &B, &T, &H};
  return launch<8>(reinterpret_cast<const void*>(lstm_fwd_persist_kernel), B, H, args,
                   (cudaStream_t)stream);
}

// lstm_bwd_f32h's arguments and `bar` as above. One launch: the T reverse
// steps and the dh0 contraction.
extern "C" int lstm_bwd_persist(const float* dy, const float* gates, const float* c_seq,
                                const float* c_prev, const void* wt, float* d_gates,
                                float* dh0, float* dc, void* bar, int B, int T, int H,
                                void* stream) {
  if (B < 1 || T < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(wt);
  unsigned* barp = static_cast<unsigned*>(bar);
  void* args[] = {&dy, &gates, &c_seq, &c_prev, &wb, &d_gates, &dh0, &dc, &barp, &B, &T, &H};
  return launch<2>(reinterpret_cast<const void*>(lstm_bwd_persist_kernel), B, H, args,
                   (cudaStream_t)stream);
}
