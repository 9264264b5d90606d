// K3 and K4 (with K1's entry) past the ladder: one Felsenstein pass over
// the Sethi-Ullman slot schedule, the variable-rate site lnL, for any
// state count past 64 (big.cuh gives the panel design and what bounds
// it).
//
// Replaces, past 64 states, phyml_tpu/ops/pallas_clv.py:_uppass_kernel
// (K3: kernel big_uppass_kernel, grid (B, tiles), entry b its own
// parameter set, or its own tree: sched_stride / param_stride as in
// clv.cu) and phyml_tpu/ops/pallas_clv_slots.py:_slot_stream_kernel (K4:
// big_slot_kernel, B = 1; the K1 entry, _slot_kernel's, launches it
// too, since no tree's resident matrices fit a warp past 64 states).
// Both compute, per pattern p (and entry b),
//
//   lse[p] = logsumexp_c( logw[c] + ln2 * sc_root[c, p]
//              + log max(FLT_MIN, sum_x pi[c, x] clv_root[c, x, p]) )
//
// with the exact power-of-two rescale and full FP32, the function of
// clv.cu and slots.cuh.
//
// The design: a block of W warps (big_warps) holds one 16-pattern tile
// and walks the C classes in turn, each a pass over the schedule (the
// wide rungs' class loop, ladder.cuh).  A step is
//
//   1. a block barrier: this step's tip rows have landed and the last
//      step's partial is in its slot;
//   2. each warp: its output panels of P_0 x_0 and P_1 x_1 (big_panels,
//      the P-matrix pieces streamed through its ring), their product
//      into `ybuf` and its column maxima into `colmax`; each thread reads
//      the children's scales of its column;
//   3. a block barrier; the next step's tip rows are copied into the tip
//      tiles (read by no one now), one cp.async group;
//   4. each thread: its column's factor over the W warps' maxima, and
//      its rows of the column scaled into the destination slot (which
//      may be a child's: every read of the children is behind the
//      barrier), the scale row beside them; at the root, the class term
//      of its column instead (one thread a column).
//
// Shared memory (big_pass_smem, floats): the warps' rings W x 2 x 2 x
// 256, two tip tiles 2 x NSp x 16, ybuf NSp x 16, colmax W x 16, the
// schedule's n_slots slots of (NSp + 1) x 16 (row NSp the log2 scale)
// and C x 16 class terms.  At 80 states (W = 5), 7 slots, C = 4: 71 KB;
// at 160 (W = 5), 7 slots: 116 KB.  Each block checks every schedule
// row once and traps on a slot or node outside the launch.
#include "big.cuh"

namespace phyml {

__device__ __forceinline__ void big_pass_body(
    const int* __restrict__ sched, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ pi,
    const float* __restrict__ logw, float* __restrict__ out, int n_otu,
    int n_int, int n_slots, int NSp, int C, int P, int ldt,
    int sched_stride, int param_stride) {
  constexpr int T = kBigTile;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x, wy = threadIdx.y, W = blockDim.y;
  const int tid = wy * 32 + lane, nthr = 32 * W;
  const int b = blockIdx.x, p0 = blockIdx.y * T;
  const int n_nodes = n_otu + n_int;
  const size_t M = static_cast<size_t>(NSp) * NSp;
  const int kSlot = (NSp + 1) * T;
  const float* pm_b = pmats + static_cast<size_t>(b) * n_nodes * C * M;
  const int bp = b * param_stride;
  sched += static_cast<size_t>(b) * sched_stride;
  float* ring = smem + wy * 2 * 2 * kBigPiece;      // my warp's
  float* tip_t = smem + W * 2 * 2 * kBigPiece;      // [2][NSp][T]
  float* ybuf = tip_t + 2 * NSp * T;                // [NSp][T]
  float* colmax = ybuf + NSp * T;                   // [W][T]
  float* slots = colmax + W * T;                    // [n_slots][NSp+1][T]
  float* red = slots + static_cast<size_t>(n_slots) * kSlot;  // [C][T]
  {
    bool bad = false;
    for (int i = tid; i < n_int; i += nthr)
      bad |= schedule_row_bad(sched, i, n_otu, n_nodes - 1, n_slots);
    if (__syncthreads_or(bad)) __trap();
  }
  auto load_row = [&](int i, int (&r)[7]) {
    if (i < n_int) {
#pragma unroll
      for (int k = 0; k < 7; ++k) r[k] = sched[7 * i + k];
    }
  };
  // the tip rows of a step (row r) into the tip tiles, one group
  auto fetch_tips = [&](const int (&r)[7]) {
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (r[3 * k + 1])
        big_copy_tip(tip_t + k * NSp * T,
                     tips + static_cast<size_t>(r[3 * k]) * NSp * ldt, NSp,
                     p0, P, ldt, tid, nthr);
    cp_async_commit();
  };
  // the thread's column in steps 3-4, and its first row
  const int j = tid % T, r0 = tid / T, rstep = nthr / T;

  for (int c = 0; c < C; ++c) {
    int cur[7], nxt[7];
    load_row(0, cur);
    load_row(1, nxt);
    fetch_tips(cur);
    const float* pm_c = pm_b + static_cast<size_t>(c) * M;
    for (int t = 0; t < n_int; ++t) {
      cp_async_wait<0>();  // my copies of this step's tip rows
      __syncthreads();     // ... everyone's; the last step's stores
      const float* x[2];
      const float* m[2];
      float sc = 0.0f;  // the children's log2 scales of column j
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (cur[3 * k + 1]) {
          x[k] = tip_t + k * NSp * T;
        } else {
          x[k] = slots + cur[3 * k + 2] * kSlot;
          sc += x[k][NSp * T + j];
        }
        m[k] = pm_c + static_cast<size_t>(cur[3 * k]) * C * M;
      }
      float cm[2] = {0.0f, 0.0f};
      big_panels<2, 0u>(ring, m, x, NSp, wy, W,
                        [&](int o, float (&acc)[2][4][2]) {
                          float y[4][2];
#pragma unroll
                          for (int a = 0; a < 4; ++a)
#pragma unroll
                            for (int q = 0; q < 2; ++q)
                              y[a][q] = acc[0][a][q] * acc[1][a][q];
                          big_store_tile(ybuf, o, y, cm);
                        });
      big_warp_colmax(cm, colmax, wy);
      __syncthreads();  // ybuf and colmax whole; the children are read
      int later[7];
      load_row(t + 2, later);
      if (t + 1 < n_int) fetch_tips(nxt);
      const float f = big_column_factor(colmax, W, j, &sc);
      if (t + 1 < n_int) {
        float* d = slots + cur[6] * kSlot;
        for (int r = r0; r < NSp; r += rstep)
          d[r * T + j] = ybuf[r * T + j] * f;
        if (r0 == 0) d[NSp * T + j] = sc;
      } else if (r0 == 0) {
        // the root: sum_x pi * clv over every state of column j
        const float* pi_c = pi + (static_cast<size_t>(bp) * C + c) * NSp;
        float l = 0.0f;
        for (int r = 0; r < NSp; ++r) l += pi_c[r] * (ybuf[r * T + j] * f);
        red[c * T + j] =
            logw[bp * C + c] + sc * kLn2 + logf(fmaxf(l, FLT_MIN));
      }
#pragma unroll
      for (int k = 0; k < 7; ++k) cur[k] = nxt[k], nxt[k] = later[k];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* out_b = out + static_cast<size_t>(b) * P;
  for (int t = tid; t < T && p0 + t < P; t += nthr)
    out_b[p0 + t] = class_lse(red + t, C, T);
}

__global__ void __launch_bounds__(32 * kBigMaxWarps)
    big_uppass_kernel(const int* __restrict__ sched,
                      const float* __restrict__ tips,
                      const float* __restrict__ pmats,
                      const float* __restrict__ pi,
                      const float* __restrict__ logw, float* __restrict__ out,
                      int n_otu, int n_int, int n_slots, int NSp, int C, int P,
                      int ldt, int sched_stride, int param_stride) {
  big_pass_body(sched, tips, pmats, pi, logw, out, n_otu, n_int, n_slots,
                NSp, C, P, ldt, sched_stride, param_stride);
}

__global__ void __launch_bounds__(32 * kBigMaxWarps)
    big_slot_kernel(const int* __restrict__ sched,
                    const float* __restrict__ tips,
                    const float* __restrict__ pmats,
                    const float* __restrict__ pi,
                    const float* __restrict__ logw, float* __restrict__ out,
                    int n_otu, int n_int, int n_slots, int NSp, int C, int P,
                    int ldt, int sched_stride, int param_stride) {
  big_pass_body(sched, tips, pmats, pi, logw, out, n_otu, n_int, n_slots,
                NSp, C, P, ldt, sched_stride, param_stride);
}

// bytes of shared memory of one block (the layout of big_pass_body)
size_t big_pass_smem(int NSp, int C, int n_slots) {
  const size_t W = big_warps(NSp), T = kBigTile;
  return (W * 2 * 2 * kBigPiece + 2 * NSp * T + NSp * T + W * T +
          static_cast<size_t>(n_slots) * (NSp + 1) * T + C * T) *
         sizeof(float);
}

int big_pass_launch(bool batched, const int* sched, const float* tips,
                    const float* pmats, const float* pi, const float* logw,
                    float* out, int n_otu, int n_int, int n_slots, int NSp,
                    int C, int P, int ldt, int B, int sched_stride,
                    int param_stride, cudaStream_t stream) {
  const int tiles = (P + kBigTile - 1) / kBigTile;
  const size_t smem = big_pass_smem(NSp, C, n_slots);
  if (!big_width(NSp) || smem > kMaxSmem || tiles > 65535 || ldt < P)
    return kUnsupported;
  auto* kernel = batched ? big_uppass_kernel : big_slot_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(B, tiles), dim3(32, big_warps(NSp)), smem, stream>>>(
      sched, tips, pmats, pi, logw, out, n_otu, n_int, n_slots, NSp, C, P,
      ldt, sched_stride, param_stride);
  return static_cast<int>(cudaGetLastError());
}

int big_pass_occupancy(bool batched, int NSp, int C, int n_slots,
                       int* blocks_per_sm) {
  const size_t smem = big_pass_smem(NSp, C, n_slots);
  if (!big_width(NSp) || smem > kMaxSmem) return kUnsupported;
  auto* kernel = batched ? big_uppass_kernel : big_slot_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, 32 * big_warps(NSp), smem));
}

}  // namespace phyml
