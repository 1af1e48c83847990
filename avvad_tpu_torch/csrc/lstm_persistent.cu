// The three inference recurrences (fp32, bf16 and int8 h) and the two
// training recurrences of one LSTM layer as persistent, weight-stationary
// kernels for Hopper (sm_90a): ONE cooperative launch per layer and
// sequence; the time loop runs inside the kernel. The quantised-state
// kernels (lstm_bf16h_persist, lstm_int8_persist) are described where they
// begin, below lstm_infer_persist_kernel.
//
// Replaces, at the shapes the plan takes (H % 4 == 0, ceil(H / 16) CTAs
// co-resident, one an SM, and their shared memory within the limit: H <= 1100
// at B=16 on a 132-SM card), the TPU kernels of avvad_tpu/ops/lstm_pallas.py:
//   lstm_f32h_persist      <- _lstm_kernel (:54) via _fwd_infer_call (:185)
//   lstm_fwd_train_persist <- _lstm_fwd_train_kernel (:116) via _fwd_train_call (:279)
//   lstm_bwd_persist       <- _lstm_bwd_kernel (:138) via _bwd_call (:314)
//   lstm_bf16h_persist     <- _lstm_kernel_hbf16 (:71) via _fwd_quant_call (:232)
//   lstm_int8_persist      <- _lstm_kernel_int8 (:92) via _fwd_quant_call (:232)
//   lstm_probe_persist     <- the probe kernel of scripts/bench_lstm_probe.py
//                             (:71, `_variant_kernel(mode).call` :102): the
//                             f32h and bf16h kernels in the probe's modes
// The Pallas kernels carry h, c, dh and dc in scratch across a sequential
// grid; here a CTA carries them across a loop. Outside the plan the wrapper
// routes to the per-step kernels lstm_f32h, lstm_bf16h, lstm_int8,
// lstm_fwd_train_f32h, lstm_probe (lstm_recurrence.cu) and lstm_bwd_f32h
// (lstm_train.cu), which compute the same functions.
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
//
// The inference kernel (B=64 at serving: 4 batch tiles a CTA) is bound by the
// same FMAs, 4.1 ms a layer at the peak, and differs where that shape does:
// its tiles go in pairs through an 8 x 8 register tile, which halves the
// weight reads and conversions per FMA (the 4 x 8 tile's shared-memory loads
// keep up with about two thirds of the FMA rate), and the chunks of a whole
// step are one stream through the ring. Tried there and dropped: a barrier
// per batch tile, so that a tile of step t + 1 would wait for its own tile of
// step t alone (slower on the card: four arrivals with their fences a step
// cost more than the one wait they hide); the chunks as cp.async.bulk rows
// onto mbarriers issued by one warp (slower than cp.async by every thread).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

// acc[i][c] += sum over this thread's groups of four k of one ring chunk:
// a_base: the chunk's row rq (rows rq + 2 i follow), w_base: the weight
// slice at the chunk's first k-group and this thread's 8 columns, ng: the
// chunk's groups of four k, q: this thread's k-group, Kq: K / 4.
template <int NCG>
__device__ __forceinline__ void contract_chunk(const float* a_base, const __nv_bfloat16* w_base,
                                               int ng, int q, int Kq, float (&acc)[4][8]) {
  typedef Tile<NCG> TL;
#pragma unroll(NCG == 8 ? 4 : 1)
  for (int gl = q; gl < ng; gl += TL::KG) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_base + 2 * i * ASTRIDE + 4 * gl);
    const __nv_bfloat16* wp = w_base + (size_t)gl * TL::NCOL;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint4 wv = *reinterpret_cast<const uint4*>(wp + (size_t)kk * Kq * TL::NCOL);
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
    contract_chunk<NCG>(ring + (chunk % NSTAGE) * (BT * ASTRIDE) + rq * ASTRIDE,
                        wsm + (size_t)(k0 >> 2) * TL::NCOL + cq * 8, min(KC, K - k0) >> 2, q,
                        Kq, acc);
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

// The probe's cuts of the fp32-h inference frame (P1, the probe kernel of
// scripts/bench_lstm_probe.py), compile-time variants of the kernels below:
// kFull is the kernel itself; kGatesOnly cuts the exchange's loads and the
// product (gates = x_proj; the weight slice is not loaded), keeping the
// barrier round, the gate math and the stores; kMatmulOnly cuts the gate
// math (h = the i columns' sums, the other three sums parked in a (B, 4H)
// scratch so that the whole product stays, c unchanged).
enum ProbeCut : int { kFull = 0, kGatesOnly = 2, kMatmulOnly = 3 };

// Forward: CTA (x, r) owns hidden units [16 x, 16 x + 16) of the batch tiles
// r, r + gridDim.y, ... Shared memory: W slice (H x 64 bf16), ring, partials,
// c of the CTA's cells. TRAIN stores the residuals (c_seq, activated gates);
// without it the kernel is the inference recurrence, y only, for grids in
// which a CTA has a single batch tile (lstm_infer_persist_kernel takes the
// others); `gates` is then the probe's scratch under kMatmulOnly. The chunks
// of every tile of a step are one stream through the ring, so a tile's first
// chunks load under the tile before.
template <bool TRAIN, int CUT = kFull>
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
  for (int idx = tid; CUT != kGatesOnly && idx < H * 16; idx += NT) {
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
  const int lane = tid & 31, warp = tid >> 5;
  const int cq = lane % 8, rq = (lane / 8) & 1, q = warp * TL::QPW + lane / 16;
  // the copy: this thread's granule column and first row
  const int gcol = tid % (KC / 4), grow = tid / (KC / 4);
  const int nchunk = (H + KC - 1) / KC;
  const int ntile = ((B + BT - 1) / BT - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  const int nstream = ntile * nchunk;  // chunks of a step: every tile's, one stream
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : y + (size_t)(t - 1) * H;
    const long long h_row = t == 0 ? (long long)H : yrow;
    // Chunk `fs` of the stream (tile fm, chunk fc of its row) into ring slot
    // fs % NSTAGE; called by every thread, two chunks ahead of the FMAs, so
    // a tile's first chunks load under the tile before.
    int fs = 0, fm = 0, fc = 0;
    auto fetch = [&]() {
      if (CUT != kGatesOnly && fs < nstream) {
        const int b0 = tile0 + fm * tile_step, k0 = fc * KC;
        if (4 * gcol < H - k0) {
          float* dst = ring + (fs % NSTAGE) * (BT * ASTRIDE) + grow * ASTRIDE + 4 * gcol;
          const float* from = h_in + (long long)(b0 + grow) * h_row + k0 + 4 * gcol;
#pragma unroll
          for (int r = grow; r < BT; r += NT / (KC / 4)) {
            if (b0 + r < B) cp_async16(dst, from);
            dst += (NT / (KC / 4)) * ASTRIDE;
            from += (NT / (KC / 4)) * h_row;
          }
        }
        ++fs;
        if (++fc == nchunk) {
          fc = 0;
          ++fm;
        }
      }
      cp_async_commit();  // an empty group keeps the count uniform
    };
    fetch();
    fetch();
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
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) acc[i][cc] = 0.0f;
      for (int chunk = 0; CUT != kGatesOnly && chunk < nchunk; ++chunk) {
        const int slot = (m * nchunk + chunk) % NSTAGE;
        cp_async_wait<1>();  // this thread's part of the chunk has landed
        __syncthreads();     // everyone's has; everyone is done with the chunk before
        fetch();             // into the slot of the chunk before
        const int k0 = chunk * KC;
        contract_chunk<8>(ring + slot * (BT * ASTRIDE) + rq * ASTRIDE,
                          wsm + (size_t)(k0 >> 2) * TL::NCOL + cq * 8, min(KC, H - k0) >> 2, q,
                          Kq, acc);
      }
      if (CUT != kGatesOnly) {
        store_partials<8>(red, acc);
        __syncthreads();
      }
      if (cell) {
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.0f;
          for (int qi = 0; CUT != kGatesOnly && qi < TL::KG; ++qi)
            s += red[qi * (BT * TL::RS) + row * TL::RS + g * U + u];
          gate[g] = CUT == kGatesOnly ? x[g] : __fadd_rn(x[g], s);
        }
        if (CUT == kMatmulOnly) {
          y[b * yrow + (size_t)t * H + j] = gate[0];
#pragma unroll
          for (int g = 1; g < 4; ++g) gates[(size_t)b * H4 + g * H + j] = gate[g];
          continue;
        }
        const float ig = sigmoid_rn(gate[0]);
        const float fg = sigmoid_rn(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoid_rn(gate[3]);
        const float cn = __fadd_rn(__fmul_rn(fg, *cell_c), __fmul_rn(ig, gg));
        *cell_c = cn;
        y[b * yrow + (size_t)t * H + j] = __fmul_rn(og, tanhf(cn));  // the exchange: first
        if (TRAIN) {
          c_seq[b * yrow + (size_t)t * H + j] = cn;
          float* gp = gates + b * xrow + (size_t)t * H4 + j;
          gp[0] = ig;
          gp[H] = fg;
          gp[2 * H] = gg;
          gp[3 * H] = og;
        }
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

// Geometry of the inference kernel: its thread tile is 8 rows x 8 columns
// over a pair of batch tiles (16 rows), so the ring's chunks are half as
// long as the training kernels'.
constexpr int KCI = 256;               // contraction columns per ring chunk
constexpr int AST_I = KCI + 8;         // floats between the rows of a chunk
constexpr int PAIR = 2 * BT;           // rows of a pair of batch tiles
constexpr int RING_I_FLOATS = NSTAGE * PAIR * AST_I;
constexpr int KG_I = NWARP;            // partials a cell sums: one a warp
constexpr int RED_I_FLOATS = KG_I * PAIR * Tile<8>::RS;

// Inference (y only): CTA (x, r) owns hidden units [16 x, 16 x + 16) of the
// batch tiles r, r + gridDim.y, ..., which it walks two at a time: a thread
// holds an 8-row x 8-column accumulator tile over the pair's 16 rows, so one
// 16-byte weight read (8 bf16) and its conversions serve 8 rows: 256 FMAs
// per 12 shared-memory loads where the training forward has 128 per 8. The
// chunks of every pair of a step are one stream through the ring, two
// chunks ahead of the FMAs, so a pair's first chunks load under the pair
// before. The two k-groups of a warp are summed by shuffle, the 8 warps'
// partials through shared memory by the cell's owner in a fixed order; all
// 256 threads own a cell of the pair. Shared memory: W slice (H x 64 bf16),
// ring, partials, c of the CTA's cells.
template <int CUT = kFull>
__global__ void __launch_bounds__(NT, 1)
lstm_infer_persist_kernel(const float* __restrict__ xp, const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ h0, float* c, float* y,
                          float* __restrict__ scratch, unsigned* bar, int B, int T, int H) {
  typedef Tile<8> TL;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wsm = reinterpret_cast<__nv_bfloat16*>(smem);
  float* ring = reinterpret_cast<float*>(smem + (size_t)H * TL::NCOL * 2);
  float* red = ring + RING_I_FLOATS;
  float* cst = red + RED_I_FLOATS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * U;
  const int H4 = 4 * H, Kq = H >> 2;

  // W[k, g H + j0 + u] -> slot [k % 4][k / 4], column g U + u; 4 bf16 a load
  for (int idx = tid; CUT != kGatesOnly && idx < H * 16; idx += NT) {
    const int k = idx >> 4, p = idx & 15, g = p >> 2, u4 = (p & 3) * 4;
    uint2 v = make_uint2(0u, 0u);
    if (j0 + u4 < H)
      v = __ldg(reinterpret_cast<const uint2*>(w + (size_t)k * H4 + g * H + j0 + u4));
    const int slot = (k & 3) * Kq + (k >> 2);
    *reinterpret_cast<uint2*>(wsm + (size_t)slot * TL::NCOL + g * U + u4) = v;
  }
  for (int i = tid; i < RING_I_FLOATS; i += NT) ring[i] = 0.0f;
  const int tile0 = BT * blockIdx.y, tile_step = BT * gridDim.y;
  const int ntile = ((B + BT - 1) / BT - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  // this thread's cell of a pair: row prow of the pair's 16, unit u
  const int prow = tid / U, u = tid % U, j = j0 + u;
  const int half = prow / BT, row = prow % BT;  // which tile of the pair, its row
  for (int m = half; m < ntile; m += 2) {
    const int b = tile0 + m * tile_step + row;
    cst[m * (BT * U) + row * U + u] = b < B && j < H ? c[(size_t)b * H + j] : 0.0f;
  }
  __syncthreads();

  const long long xrow = (long long)T * H4, yrow = (long long)T * H;
  const int cq = lane % 8, rq = (lane / 8) & 1;
  // the copy: this thread's granule column and first row
  const int gcol = tid % (KCI / 4), grow = tid / (KCI / 4);
  const int nchunk = (H + KCI - 1) / KCI;
  const int npair = (ntile + 1) / 2;
  const int nstream = npair * nchunk;  // chunks of a step: every pair's, one stream
  for (int t = 0; t < T; ++t) {
    const float* h_in = t == 0 ? h0 : y + (size_t)(t - 1) * H;
    const long long h_row = t == 0 ? (long long)H : yrow;
    int fs = 0, fp = 0, fc = 0;  // the next chunk to fetch: stream index, pair, chunk
    auto fetch = [&]() {
      if (CUT != kGatesOnly && fs < nstream) {
        const int k0 = fc * KCI;
        if (4 * gcol < H - k0) {
          float* dst = ring + (fs % NSTAGE) * (PAIR * AST_I) + 4 * gcol;
#pragma unroll
          for (int r = grow; r < PAIR; r += NT / (KCI / 4)) {
            const int m = 2 * fp + r / BT;
            const int b = tile0 + m * tile_step + r % BT;
            if (m < ntile && b < B)
              cp_async16(dst + r * AST_I, h_in + (long long)b * h_row + k0 + 4 * gcol);
          }
        }
        ++fs;
        if (++fc == nchunk) {
          fc = 0;
          ++fp;
        }
      }
      cp_async_commit();  // an empty group keeps the count uniform
    };
    fetch();
    fetch();
    for (int pr = 0; pr < npair; ++pr) {
      const int m = 2 * pr + half;
      const int b = tile0 + m * tile_step + row;
      const bool cell = m < ntile && b < B && j < H;
      float x[4];
      if (cell) {  // in flight during the contraction
#pragma unroll
        for (int g = 0; g < 4; ++g) x[g] = __ldg(xp + b * xrow + (size_t)t * H4 + g * H + j);
      }
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) acc[i][cc] = 0.0f;
      for (int chunk = 0; CUT != kGatesOnly && chunk < nchunk; ++chunk) {
        const int slot = (pr * nchunk + chunk) % NSTAGE;
        cp_async_wait<1>();  // this thread's part of the chunk has landed
        __syncthreads();     // everyone's has; everyone is done with the chunk before
        fetch();             // into the slot of the chunk before
        const int k0 = chunk * KCI;
        const int ng = min(KCI, H - k0) >> 2;
        const float* a_base = ring + slot * (PAIR * AST_I) + rq * AST_I;
        const __nv_bfloat16* w_base = wsm + (size_t)(k0 >> 2) * TL::NCOL + cq * 8;
#pragma unroll 2
        for (int gl = warp * 2 + lane / 16; gl < ng; gl += 2 * NWARP) {
          float4 a[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            a[i] = *reinterpret_cast<const float4*>(a_base + 2 * i * AST_I + 4 * gl);
          const __nv_bfloat16* wp = w_base + (size_t)gl * TL::NCOL;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint4 wv = *reinterpret_cast<const uint4*>(wp + (size_t)kk * Kq * TL::NCOL);
            const unsigned wu[4] = {wv.x, wv.y, wv.z, wv.w};
            float wf[8];
#pragma unroll
            for (int p = 0; p < 4; ++p) {  // bf16 -> fp32 is a shift into the high half
              wf[2 * p] = __uint_as_float(wu[p] << 16);
              wf[2 * p + 1] = __uint_as_float(wu[p] & 0xffff0000u);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
              for (int cc = 0; cc < 8; ++cc) acc[i][cc] = __fmaf_rn(av, wf[cc], acc[i][cc]);
            }
          }
        }
      }
      // the warp's two k-groups by shuffle, then red[warp][row of the pair][column]
      if (CUT != kGatesOnly) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) acc[i][cc] += __shfl_xor_sync(0xffffffffu, acc[i][cc], 16);
        if (lane < 16) {
          float* r = red + warp * (PAIR * TL::RS) + cq * 8;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float4* pp = reinterpret_cast<float4*>(r + (rq + 2 * i) * TL::RS);
            pp[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            pp[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
          }
        }
        __syncthreads();
      }
      if (cell) {
        float* cell_c = cst + m * (BT * U) + row * U + u;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float s = 0.0f;
#pragma unroll
          for (int qi = 0; CUT != kGatesOnly && qi < KG_I; ++qi)
            s += red[qi * (PAIR * TL::RS) + prow * TL::RS + g * U + u];
          gate[g] = CUT == kGatesOnly ? x[g] : __fadd_rn(x[g], s);
        }
        if (CUT == kMatmulOnly) {
          y[b * yrow + (size_t)t * H + j] = gate[0];
#pragma unroll
          for (int g = 1; g < 4; ++g) scratch[(size_t)b * H4 + g * H + j] = gate[g];
          continue;
        }
        const float ig = sigmoid_rn(gate[0]);
        const float fg = sigmoid_rn(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoid_rn(gate[3]);
        const float cn = __fadd_rn(__fmul_rn(fg, *cell_c), __fmul_rn(ig, gg));
        *cell_c = cn;
        y[b * yrow + (size_t)t * H + j] = __fmul_rn(og, tanhf(cn));
      }
    }
    if (t + 1 < T) {  // y[rows, t] complete on every CTA of the slice before it is read
      grid_arrive(bar + blockIdx.y);
      grid_wait(bar + blockIdx.y, gridDim.x * (unsigned)(t + 1));
    }
  }
  for (int m = half; m < ntile; m += 2) {
    const int b = tile0 + m * tile_step + row;
    if (b < B && j < H) c[(size_t)b * H + j] = cst[m * (BT * U) + row * U + u];
  }
}

// ---------------------------------------------------------------------------
// The quantised-state inference recurrences on the tensor cores:
//   lstm_bf16h_persist <- _lstm_kernel_hbf16 (:71) via _fwd_quant_call (:232)
//   lstm_int8_persist  <- _lstm_kernel_int8 (:92) via _fwd_quant_call (:232)
// The per-step lstm_bf16h / lstm_int8 (lstm_recurrence.cu) compute the same
// functions outside the plan. Numerics: bf16 h = __float2bfloat16_rn(h) times
// the bf16 W, exact products summed in fp32 by mma; int8 qh =
// __float2int_rn(h * 127) times Wq, exact int32 sums, gates = x + f32(acc) *
// ws. The int8 kernel equals the per-step one and the plain version bit for
// bit; the bf16 one differs by the tensor cores' fp32 accumulation order.
//
// What bounds them at B=64, T=512, H=1024: 2*B*T*H*4H = 275 G operations,
// 0.28 ms at the bf16 and 0.14 ms at the int8 tensor-core peak, against 0.2
// ms of bytes; and the T-long chain of steps, each a barrier round (about
// 1.3 us alone on an H100, tools/lstm_step_split.py: a 0.7 ms floor a
// layer). A CTA's product is 32 rows x 64 columns (int8: 16 x 128) x 1024 k a
// step, under a microsecond on one SM's tensor cores, so the chain sets the
// step: the barrier, the
// exchange's way back from L2, the product, the gate math, the fence. The
// frame is lstm_infer_persist_kernel's (weight slice resident, c in shared
// memory, a barrier per row slice and step); what changes:
//  - The product is mma.sync m16n8k16 bf16 (m16n8k32 s8) with fragments from
//    ldmatrix. In bytes the two are one code: a k step is 32 bytes of a row
//    (16 bf16 or 32 int8). The weight slice is stored [column][k], k
//    contiguous, rows padded by 16 bytes so that ldmatrix is conflict-free;
//    the K tail (H * element size up to a multiple of 32 bytes) is zero.
//  - The exchange carries the quantised h, not y: the cell's owner writes y
//    (fp32, the output) and the rounded h into a buffer of 2 x B rows of the
//    padded length, by step parity (a CTA that runs ahead writes h_t while a
//    slower one still reads h_{t-1}; a single buffer would race). Rounding
//    once at the writer equals rounding at every reader. A row is 2 KB (bf16)
//    or 1 KB (int8) at H=1024, against 4 KB of fp32: a CTA of the serving
//    plan pulls 64 KB (bf16, 32 rows) or 16 KB (int8, 16 rows) a step
//    through L2 where K1a pulls 128 KB.
//  - A CTA owns UQ units: 16 for bf16 (64 columns, a 129 KB slice at
//    H=1024, the grid of the other kernels: 64 x 2 at B=64), 32 for int8
//    (128 columns of half the bytes, the same 129 KB; 32 x 4 CTAs at B=64,
//    so a CTA pulls 16 rows where it would pull 32: faster than 16 units,
//    tools/lstm_step_split.py times both). A CTA walks its batch tiles in
//    groups of 512 / UQ rows (two cells a thread); the 8 warps split a
//    group's product into 32-column groups x k-groups (k step q of every
//    KG), 8 (bf16) or 4 (int8) mma a k step each, and the k-groups' partials
//    are summed by the cell's owner in a fixed order (two launches agree bit
//    for bit).
//    The chunks of a group stream through a ring of four 512-byte chunks a
//    row, three ahead of the mma, read with cp.async.cg as in K1a; between
//    a group's last chunk and the next group the ring holds the partials.
//  - h0 is rounded into the buffer by the cells' owners before the first
//    step, behind one more barrier round.
// Tried on the card and dropped: rings of 3 chunks or of 256-byte chunks
// (tools/lstm_step_split.py times them); a chunk's fragments all loaded
// before its mma (slower), y stored after the barrier's arrival and a deeper
// unroll (within the calls' spread). The first build indexed the
// accumulators at run time when it stored the partials: 128 bytes of stack,
// and a third slower.

constexpr int UQ_BF16 = 16;               // hidden units a CTA owns: bf16 kernel
constexpr int UQ_INT8 = 32;               // int8 kernel: half the bytes a column
constexpr int KCB = 512;                  // bytes of a row per ring chunk
constexpr int ARS = KCB + 16;             // bytes between the rows of a chunk
constexpr int QSTAGE = 4;                 // ring chunks
constexpr int QAHEAD = QSTAGE - 1;        // chunks in flight ahead of the mma

// Geometry of a quantised kernel whose CTA owns UQ hidden units (4 UQ
// weight columns): a group of batch tiles has 2 x NT cells (QR rows, two
// cells a thread); its product is split over 32-column groups x k-groups,
// one warp each; a k-group's partials are QR rows x QRS words.
template <int UQ>
struct QGeo {
  static constexpr int NCOL = 4 * UQ;
  static constexpr int QR = 2 * NT / UQ;           // rows of a group of tiles
  static constexpr int TPG = QR / BT;              // tiles of a group
  static constexpr int CG = NCOL / 32;             // column groups
  static constexpr int KG = NWARP / CG;            // k-groups
  static constexpr int MT = QR / 16;               // m16 tiles of a full group
  static constexpr int QRS = NCOL + 8;             // words between partial rows
  static constexpr int RING_BYTES = QSTAGE * QR * ARS;
  static constexpr int RED_BYTES = KG * QR * QRS * 4;
  static_assert(RED_BYTES <= RING_BYTES, "the partials live in the idle ring");
  static_assert(QR % 16 == 0 && NCOL % 32 == 0 && NWARP % CG == 0, "whole mma tiles");
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a . b on one m16 x n8 tile and one k step (32 bytes)
__device__ __forceinline__ void mma_kstep(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_kstep(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bytes of a padded row of the exchange and of a weight column: H elements
// up to a multiple of the 32-byte k step
__host__ __device__ __forceinline__ int quant_row_bytes(int H, bool int8) {
  return ((int8 ? H : 2 * H) + 31) / 32 * 32;
}

// The quantised h of a cell, as the exchange stores it
template <bool INT8>
__device__ __forceinline__ void store_quant(unsigned char* p, float h) {
  if (INT8)
    *reinterpret_cast<signed char*>(p) = (signed char)__float2int_rn(__fmul_rn(h, 127.0f));
  else
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(h);
}

// CTA (x, r) owns hidden units [UQ x, UQ x + UQ) of the batch tiles r,
// r + gridDim.y, ..., walked in groups of QGeo<UQ>::TPG. w: (H, 4H)
// row-major, bf16 or int8; ws (4H,) = w_scale / 127 (int8 only); hx: the
// exchange, 2 x B rows of quant_row_bytes(H) bytes, zero beyond H (the
// wrapper zeroes it). Shared memory: W slice (4 UQ columns of the padded row
// + 16 bytes), ring (between a group's last chunk and the next group the
// k-groups' partials), c of the CTA's cells.
template <bool INT8, int UQ>
__global__ void __launch_bounds__(NT, 1)
lstm_quant_persist_kernel(const float* __restrict__ xp, const void* __restrict__ w,
                          const float* __restrict__ ws, const float* __restrict__ h0,
                          float* c, float* y, unsigned char* hx, unsigned* bar, int B, int T,
                          int H) {
  typedef QGeo<UQ> G;
  typedef typename std::conditional<INT8, int, float>::type acc_t;
  constexpr int ES = INT8 ? 1 : 2;  // bytes an element
  extern __shared__ __align__(16) unsigned char smem[];
  const int kbp = quant_row_bytes(H, INT8), WS = kbp + 16;
  unsigned char* wsm = smem;
  unsigned char* ring = smem + (size_t)G::NCOL * WS;
  acc_t* red = reinterpret_cast<acc_t*>(ring);
  float* cst = reinterpret_cast<float*>(ring + G::RING_BYTES);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * UQ;
  const int H4 = 4 * H;

  // zeros first: the K tail and the columns of units >= H stay 0
  for (int i = tid; i < (G::NCOL * WS + G::RING_BYTES) / 16; i += NT)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // W[k, g H + j0 + u] -> column g UQ + u, byte k ES; four units a load
  for (int idx = tid; idx < H * UQ; idx += NT) {
    const int k = idx / UQ, p = idx % UQ, g = p / (UQ / 4), u4 = p % (UQ / 4) * 4;
    if (j0 + u4 >= H) continue;
    const size_t off = (size_t)k * H4 + g * H + j0 + u4;
    unsigned char* col = wsm + (size_t)(g * UQ + u4) * WS + k * ES;
    if (INT8) {
      const unsigned v =
          __ldg(reinterpret_cast<const unsigned*>(static_cast<const signed char*>(w) + off));
#pragma unroll
      for (int e = 0; e < 4; ++e) col[e * WS] = (unsigned char)(v >> (8 * e));
    } else {
      const uint2 v =
          __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(w) + off));
      const unsigned vv[2] = {v.x, v.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        *reinterpret_cast<unsigned short*>(col + e * WS) =
            (unsigned short)(vv[e >> 1] >> (16 * (e & 1)));
    }
  }
  const int tile0 = BT * blockIdx.y, tile_step = BT * gridDim.y;
  const int ntile = ((B + BT - 1) / BT - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  const int ngroup = (ntile + G::TPG - 1) / G::TPG;
  // this thread's two cells of a group: rows crow and crow + QR / 2, unit u
  const int crow = tid / UQ, u = tid % UQ, j = j0 + u;
  float wsc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (INT8 && j < H) {
#pragma unroll
    for (int g = 0; g < 4; ++g) wsc[g] = __ldg(ws + g * H + j);
  }
  // row r of group gi: batch row b of the CTA's tile m, if there is one
  auto row_of = [&](int gi, int r, int& m) {
    m = G::TPG * gi + r / BT;
    return tile0 + m * tile_step + r % BT;
  };
  // c of the cells and the rounded h0 of the exchange's first rows
  const size_t hx_half = (size_t)B * kbp;
  for (int gi = 0; gi < ngroup; ++gi) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = crow + e * (G::QR / 2);
      int m;
      const int b = row_of(gi, r, m);
      if (m < ntile && b < B && j < H) {
        cst[m * (BT * UQ) + (r % BT) * UQ + u] = c[(size_t)b * H + j];
        store_quant<INT8>(hx + (size_t)b * kbp + (size_t)j * ES, h0[(size_t)b * H + j]);
      }
    }
  }
  unsigned* my_bar = bar + blockIdx.y;  // rows are independent: a barrier a row slice
  grid_arrive(my_bar);
  grid_wait(my_bar, gridDim.x);

  const long long xrow = (long long)T * H4, yrow = (long long)T * H;
  // the copy: this thread's 16-byte granule of a row, its first row
  const int gcol = tid % (KCB / 16), grow = tid / (KCB / 16);
  const int nchunk = (kbp + KCB - 1) / KCB;
  // the product: this warp's column group and k-group
  const int cg = warp % G::CG, kg = warp / G::CG;
  // ldmatrix addresses: A row of an m16 tile and byte; W column and byte
  const int a_row = lane & 15, a_byte = (lane >> 4) * 16;
  const int w_col = cg * 32 + (lane & 7) + (lane >> 4) * 8, w_byte = ((lane >> 3) & 1) * 16;
  for (int t = 0; t < T; ++t) {
    const unsigned char* h_in = hx + (t & 1) * hx_half;
    unsigned char* h_out = hx + ((t + 1) & 1) * hx_half;
    for (int gi = 0; gi < ngroup; ++gi) {
      const int mt = (min(G::TPG, ntile - G::TPG * gi) + 1) / 2;  // m16 tiles of the group
      // Chunk fc of the group's rows into ring slot fc % QSTAGE; called by
      // every thread, QAHEAD chunks ahead of the mma
      int fc = 0;
      auto fetch = [&]() {
        if (fc < nchunk) {
          const int k0 = fc * KCB;
          if (16 * gcol < kbp - k0) {
            unsigned char* dst = ring + (fc % QSTAGE) * (G::QR * ARS) + 16 * gcol;
#pragma unroll
            for (int r = grow; r < G::QR; r += NT / (KCB / 16)) {
              int m;
              const int b = row_of(gi, r, m);
              if (m < ntile && b < B)
                cp_async16(dst + r * ARS, h_in + (size_t)b * kbp + k0 + 16 * gcol);
            }
          }
          ++fc;
        }
        cp_async_commit();  // an empty group keeps the count uniform
      };
      if (gi > 0) __syncthreads();  // everyone is done with the partials in the ring
#pragma unroll
      for (int i = 0; i < QAHEAD; ++i) fetch();
      float x[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // in flight during the contraction
        const int r = crow + e * (G::QR / 2);
        int m;
        const int b = row_of(gi, r, m);
        if (m < ntile && b < B && j < H) {
#pragma unroll
          for (int g = 0; g < 4; ++g) x[e][g] = __ldg(xp + b * xrow + (size_t)t * H4 + g * H + j);
        }
      }
      acc_t acc[G::MT][4][4];
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mi][n][i] = 0;
      for (int chunk = 0; chunk < nchunk; ++chunk) {
        const int slot = chunk % QSTAGE;
        cp_async_wait<QAHEAD - 1>();  // this thread's part of the chunk has landed
        __syncthreads();              // everyone's has; everyone is done with the chunk before
        fetch();                      // into the slot of the chunk before
        const int k0 = chunk * KCB;
        const int nks = min(KCB, kbp - k0) / 32;
        const unsigned char* a_base = ring + slot * (G::QR * ARS) + a_row * ARS + a_byte;
        const unsigned char* w_base = wsm + (size_t)w_col * WS + k0 + w_byte;
#pragma unroll 2
        for (int ks = kg; ks < nks; ks += G::KG) {
          unsigned a[G::MT][4], bw[2][4];
#pragma unroll
          for (int mi = 0; mi < G::MT; ++mi)
            if (mi < mt) ldmatrix_x4(a[mi], a_base + mi * 16 * ARS + ks * 32);
          ldmatrix_x4(bw[0], w_base + ks * 32);
          ldmatrix_x4(bw[1], w_base + (size_t)16 * WS + ks * 32);
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int mi = 0; mi < G::MT; ++mi)
              if (mi < mt)
                mma_kstep(acc[mi][n], a[mi], bw[n >> 1][2 * (n & 1)], bw[n >> 1][2 * (n & 1) + 1]);
        }
      }
      // the k-group's partials into red[kg][row of the group][column], once
      // every warp is done with the ring
      __syncthreads();
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi) {
        if (mi == mt) break;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          acc_t* p = red + (kg * G::QR + mi * 16 + (lane >> 2)) * G::QRS + cg * 32 + n * 8 +
                     2 * (lane & 3);
          p[0] = acc[mi][n][0];
          p[1] = acc[mi][n][1];
          p[8 * G::QRS] = acc[mi][n][2];
          p[8 * G::QRS + 1] = acc[mi][n][3];
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = crow + e * (G::QR / 2);
        int m;
        const int b = row_of(gi, r, m);
        if (!(m < ntile && b < B && j < H)) continue;
        float gate[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc_t s = 0;
#pragma unroll
          for (int q = 0; q < G::KG; ++q) s += red[(q * G::QR + r) * G::QRS + g * UQ + u];
          gate[g] = INT8 ? __fadd_rn(x[e][g], __fmul_rn((float)s, wsc[g]))
                         : __fadd_rn(x[e][g], (float)s);
        }
        const float ig = sigmoid_rn(gate[0]);
        const float fg = sigmoid_rn(gate[1]);
        const float gg = tanhf(gate[2]);
        const float og = sigmoid_rn(gate[3]);
        float* cell_c = cst + m * (BT * UQ) + (r % BT) * UQ + u;
        const float cn = __fadd_rn(__fmul_rn(fg, *cell_c), __fmul_rn(ig, gg));
        *cell_c = cn;
        const float hn = __fmul_rn(og, tanhf(cn));
        y[b * yrow + (size_t)t * H + j] = hn;
        store_quant<INT8>(h_out + (size_t)b * kbp + (size_t)j * ES, hn);  // the exchange
      }
    }
    if (t + 1 < T) {  // h_t of the slice's rows complete on every CTA before it is read
      grid_arrive(my_bar);
      grid_wait(my_bar, gridDim.x * (unsigned)(t + 2));
    }
  }
  if (tid < BT * UQ && j < H) {
    const int r = tid / UQ;
    for (int m = 0; m < ntile; ++m) {
      const int b = tile0 + m * tile_step + r;
      if (b < B) c[(size_t)b * H + j] = cst[m * (BT * UQ) + r * UQ + u];
    }
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
int row_slices(int B, int H, int sms, int units = U) {
  const int tiles = (B + BT - 1) / BT, gx = (H + units - 1) / units;
  return tiles < sms / gx ? tiles : sms / gx;
}

// Shared memory of a CTA: the weight slice (128 H bytes in both kernels),
// the ring, the partials and the state of its batch tiles.
template <int NCG>
size_t smem_bytes(int B, int slices) {
  const int tiles = ((B + BT - 1) / BT + slices - 1) / slices;
  return (size_t)(RING_FLOATS + Tile<NCG>::RED_FLOATS + tiles * BT * U) * 4;
}

size_t smem_bytes_infer(int B, int slices) {
  const int tiles = ((B + BT - 1) / BT + slices - 1) / slices;
  return (size_t)(RING_I_FLOATS + RED_I_FLOATS + tiles * BT * U) * 4;
}

template <int UQ>
size_t smem_bytes_quant(int B, int H, int slices, bool int8) {
  const int tiles = ((B + BT - 1) / BT + slices - 1) / slices;
  return (size_t)QGeo<UQ>::NCOL * (quant_row_bytes(H, int8) + 16) + QGeo<UQ>::RING_BYTES +
         (size_t)tiles * BT * UQ * 4;
}

// One cooperative launch of ceil(H / units) x slices CTAs, after the
// occupancy says that they fit the card together; smem_of(B, slices): the
// shared memory of a CTA.
template <typename SmemOf>
int launch(const void* kernel, int B, int H, SmemOf smem_of, void** args,
           cudaStream_t stream, int units = U) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int gx = (H + units - 1) / units, slices = row_slices(B, H, sms, units);
  if (slices < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const size_t smem = smem_of(B, slices);
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

// The fp32-h inference frame in one of the probe's cuts (kFull: K1a itself).
// Grids in which a CTA walks two or more batch tiles run
// lstm_infer_persist_kernel (tiles in pairs); where every CTA has one tile, a
// pair would be half empty, and the training forward runs without its
// residual stores. scratch: (B, 4H) f32 under kMatmulOnly, else unused.
template <int CUT>
int f32h_persist(const float* xp, const void* w, const float* h0, float* c, float* y,
                 float* scratch, void* bar, int B, int T, int H, cudaStream_t stream) {
  if (B < 1 || T < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  unsigned* barp = static_cast<unsigned*>(bar);
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  const int slices = row_slices(B, H, sms);
  if (slices >= 1 && (B + BT - 1) / BT > slices) {
    void* args[] = {&xp, &wb, &h0, &c, &y, &scratch, &barp, &B, &T, &H};
    return launch(reinterpret_cast<const void*>(lstm_infer_persist_kernel<CUT>), B, H,
                  [H](int b, int s) { return 128 * (size_t)H + smem_bytes_infer(b, s); }, args,
                  stream);
  }
  float* none = nullptr;
  void* args[] = {&xp, &wb, &h0, &c, &y, &none, &scratch, &barp, &B, &T, &H};
  return launch(reinterpret_cast<const void*>(lstm_fwd_persist_kernel<false, CUT>), B, H,
                [H](int b, int s) { return 128 * (size_t)H + smem_bytes<8>(b, s); }, args,
                stream);
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
  return launch(reinterpret_cast<const void*>(lstm_fwd_persist_kernel<true>), B, H,
                [H](int b, int s) { return 128 * (size_t)H + smem_bytes<8>(b, s); }, args,
                (cudaStream_t)stream);
}

// The inference recurrence (lstm_f32h's arguments, batch-major) as one
// cooperative launch a layer. `bar`: zeroed 32-bit counters, one a batch tile
// of 8 rows (a row slice uses one).
extern "C" int lstm_f32h_persist(const float* xp, const void* w, const float* h0, float* c,
                                 float* y, void* bar, int B, int T, int H, void* stream) {
  return f32h_persist<kFull>(xp, w, h0, c, y, nullptr, bar, B, T, H, (cudaStream_t)stream);
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
  return launch(reinterpret_cast<const void*>(lstm_bwd_persist_kernel), B, H,
                [H](int b, int s) { return 128 * (size_t)H + smem_bytes<2>(b, s); }, args,
                (cudaStream_t)stream);
}

// The quantised-state inference recurrences (lstm_bf16h's / lstm_int8's
// arguments, batch-major; wq here the row-major (H, 4H) int8 weight, not the
// per-step kernel's packed words) as one cooperative launch a layer. hx: the
// exchange, 2 x B rows of the H elements padded with zeros to a multiple of
// 32 bytes (2 * 2 * B * 1024 or 2 * B * 1024 bytes at H=1024), zeroed; bar:
// zeroed 32-bit counters, one a batch tile of 8 rows. A shape outside the
// plan is an error, never another route.
extern "C" int lstm_bf16h_persist(const float* xp, const void* w, const float* h0, float* c,
                                  float* y, void* hx, void* bar, int B, int T, int H,
                                  void* stream) {
  if (B < 1 || T < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  const float* none = nullptr;
  unsigned char* hxp = static_cast<unsigned char*>(hx);
  unsigned* barp = static_cast<unsigned*>(bar);
  void* args[] = {&xp, &w, &none, &h0, &c, &y, &hxp, &barp, &B, &T, &H};
  return launch(reinterpret_cast<const void*>(lstm_quant_persist_kernel<false, UQ_BF16>), B, H,
                [H](int b, int s) { return smem_bytes_quant<UQ_BF16>(b, H, s, false); }, args,
                (cudaStream_t)stream, UQ_BF16);
}

extern "C" int lstm_int8_persist(const float* xp, const void* wq, const float* ws,
                                 const float* h0, float* c, float* y, void* hx, void* bar,
                                 int B, int T, int H, void* stream) {
  if (B < 1 || T < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  unsigned char* hxp = static_cast<unsigned char*>(hx);
  unsigned* barp = static_cast<unsigned*>(bar);
  void* args[] = {&xp, &wq, &ws, &h0, &c, &y, &hxp, &barp, &B, &T, &H};
  return launch(reinterpret_cast<const void*>(lstm_quant_persist_kernel<true, UQ_INT8>), B, H,
                [H](int b, int s) { return smem_bytes_quant<UQ_INT8>(b, H, s, true); }, args,
                (cudaStream_t)stream, UQ_INT8);
}

// P1, the probe (scripts/bench_lstm_probe.py), on the persistent frame: one
// cooperative launch a layer of the kernel that serving runs at the shape, in
// one of the probe's modes as a compile-time variant. lstm_f32h_persist's
// arguments with a (B, 4H) f32 scratch (mode 3 only) and, for mode 1, the
// exchange hx of lstm_bf16h_persist. mode 0 "full": lstm_f32h_persist
// itself; 1 "h_bf16": lstm_bf16h_persist itself (w the bf16 weight, hx zeroed);
// 2 "gates_only": kGatesOnly (w is not read); 3 "matmul_only": kMatmulOnly
// (c is not touched). A shape outside the plan is an error.
extern "C" int lstm_probe_persist(const float* xp, const void* w, const float* h0, float* c,
                                  float* y, float* scratch, void* hx, void* bar, int B, int T,
                                  int H, int mode, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return f32h_persist<kFull>(xp, w, h0, c, y, nullptr, bar, B, T, H, st);
    case 1:
      return lstm_bf16h_persist(xp, w, h0, c, y, hx, bar, B, T, H, stream);
    case 2:
      return f32h_persist<kGatesOnly>(xp, w, h0, c, y, nullptr, bar, B, T, H, st);
    case 3:
      return f32h_persist<kMatmulOnly>(xp, w, h0, c, y, scratch, bar, B, T, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
