// K3: slot-scheduled Felsenstein pass, variable-rate site lnL, batched
// over parameter sets.
//
// Replaces phyml_tpu/ops/pallas_clv.py:_uppass_kernel (wrapper
// uppass_site_lse), and with its leading batch dimension the vmap of
// that kernel in the parameter line search (B = 13 per free scalar),
// the line search's pair probe (B = 2) and the branch-length probes
// (B = 1).  With one schedule per batch entry it also serves the rapid
// bootstrap's backtracking probes: entry b is replicate tree b (its own
// schedule and P-matrices, one system broadcast), which phyml_tpu runs
// as the same kernel under jax.vmap over stacked trees
// (phyml_tpu/optim/blen.py:139-159).  Per pattern p and entry b it
// computes
//
//   lse[b, p] = logsumexp_c( logw[b, c] + ln2 * sc_root[b, c, p]
//                 + log max(FLT_MIN, sum_x pi[b, c, x] clv_root[b, c, x, p]) )
//
// with the exact power-of-two rescale of common.cuh and full FP32.
//
// What bounds it on the H100: the matvecs, 2*ns^2 FLOPs per child,
// class, pattern and parameter set (0.63 ms of FP32 at 128 x 3945
// amino acids, C = 4, B = 13); device memory moves only the operands
// and `out`.  The design keeps every partial on chip and feeds the FMA
// pipes from registers:
//
// * Partials live in shared memory under the Sethi-Ullman slot
//   schedule of K1/K4 (ops/clv_slots.py:build_slot_schedule), not in a
//   device-memory workspace: n_slots * (ns + 1) floats per (pattern,
//   class), entry ns holding the slot's log2 scale.  The wrapper passes
//   the schedule's own slot count (6 for a balanced 128-taxon tree, 4
//   for the bench trees, 1 for a caterpillar; at most
//   ceil(log2 n_otu) + 1).
// * Staged operands: each step's two child P-matrices (C*ns^2 floats of
//   parameter set b: 256 B at DNA, 6.4 KB at protein, C = 4) and, for
//   tip children, their rows of `tips` for the block's pattern tile are
//   copied into one half of a double-buffered shared-memory ring with
//   cp.async while the step before computes (one block barrier per
//   step).  cp.async and not the 1-D bulk copy: the tip rows of
//   tips [n_otu, ns, P] start at unaligned addresses whenever P is odd
//   (3767, 3945), which a bulk copy refuses, the matrices are a few
//   hundred 16-byte pieces per step that 128 threads issue in a few
//   instructions each, and K4 already runs this form on the card.
// * Register tiles: a step is, per (b, class), Y_k = P_k X_k for the
//   two children, X an ns x T tile.  Each thread owns R output states
//   by Q patterns of one class: it loads its R rows of P_k as 16-byte
//   pieces and X as (state, Q-pattern) pieces from shared memory, R*Q
//   FMAs for every 4-wide P piece and every X piece.  ns = 4, R = 4,
//   Q = 2: 64 FMAs per 16 loads (4 per load); ns = 20, R = 5, Q = 4:
//   400 FMAs per child from 25 + 20 loads (8.9 per load); a plain
//   matvec makes one load per FMA.  One Q per state count: at
//   ns = 4, Q = 4 ran no faster than Q = 2 at the line search's B = 65;
//   at ns = 20, Q = 4 halves the P-matrix loads per FMA.
// * At ns = 20 a pattern column is split over G = 4 adjacent lanes
//   (states 5g..5g+4); the rescale's column max and the root's sum over
//   states are exchanged with two xor shuffles.  Every lane that reads
//   a column lies in the warp that writes it, so the slots need only
//   __syncwarp (before a step's stores, since the destination slot may
//   be one the step reads: a caterpillar walks one slot in place).
// * The schedule's rows are loaded two steps ahead into registers, so
//   no step waits on them after its barrier.  Each block first checks
//   the whole schedule, a row per thread: a slot index outside
//   [0, n_slots) or a node outside the tree traps (a device-side
//   assert, as PyTorch's own index checks), since the slots index
//   shared memory.
// * Batch entries: `sched_stride` is 0 (one schedule for every entry,
//   the line search) or n_int * 7 (entry b walks schedule b, the stacked
//   replicate trees; n_slots is then the largest of their slot counts);
//   `param_stride` is 1 (a system per entry) or 0 (one system for all,
//   the replicates' frozen estimates: pi and logw read at b = 0).
// * Grid (B, pattern tiles): blockIdx.x = b runs fastest, so the blocks
//   that share a tile's tip rows are dispatched together and meet them
//   in L2.  Block = one warp per class, all on one tile of
//   T = 32 / G * Q patterns (ns = 4: 64; ns = 20: 32), a compile-time
//   width, so every shared-memory offset but the slot index and the
//   class is a constant.  The ragged last tile copies the last valid
//   column into its spare columns (never stored) and stores no column
//   past P.
//
// Budget per block at C = 4 (floats x 4 B): slots n_slots * C * (ns+1)
// * T, ring 4*C*ns^2 + 4*ns*T, class terms C*T; registers from ptxas
// (-Xptxas -v, no spill at either ns), allocated in 8s.  At the bench
// trees' 4 slots:
//   ns = 20, T = 32: slots 43 KB + ring 25.6 + 10.2 KB = 79.4 KB, 125
//     registers: 2 blocks (8 warps) per SM, by shared memory.  (84 B
//     per (pattern, class) and slot: 756 B at 9 slots.)
//   ns = 4, T = 64: 20.5 + 1 + 4.1 KB = 26.6 KB, 67 registers: 7
//     blocks (28 warps) per SM, by registers.
// chip_smoke.py prints the registers and the blocks per SM the runtime
// grants (phyml_batched_uppass_occupancy).
#include "common.cuh"

namespace phyml {

// R output states and Q patterns per thread at each instantiated state
// count
template <int NS>
constexpr int kRows = NS == 20 ? 5 : NS;
template <int NS>
constexpr int kCols = NS == 20 ? 4 : 2;

// patterns one warp covers, the block's pattern tile
template <int NS>
constexpr int kTile = 32 / (NS / kRows<NS>) * kCols<NS>;

// load_q, store_q, tile_matmul and column_max / column_sum are in
// common.cuh, shared with K2 and K5.

template <int NS>
__global__ void batched_uppass_kernel(const int* __restrict__ sched,
                                      const float* __restrict__ tips,
                                      const float* __restrict__ pmats,
                                      const float* __restrict__ pi,
                                      const float* __restrict__ logw,
                                      float* __restrict__ out, int n_nodes,
                                      int n_int, int n_slots, int P,
                                      int sched_stride, int param_stride) {
  constexpr int R = kRows<NS>, G = NS / R, Q = kCols<NS>;
  constexpr int T = kTile<NS>;           // the block's pattern tile
  constexpr int kSlot = (NS + 1) * T;    // floats of one slot, class
  extern __shared__ __align__(16) float smem[];
  const int C = blockDim.y;
  const int lane = threadIdx.x, c = threadIdx.y;
  const int tid = c * 32 + lane, nthr = 32 * C;
  const int g = lane % G;             // my state group
  const int lp = lane / G * Q;        // my first pattern
  const int b = blockIdx.x, p0 = blockIdx.y * T;
  const int mat = C * NS * NS;  // floats of one node's P-matrices
  const float* pm_b = pmats + static_cast<size_t>(b) * n_nodes * mat;
  const int bp = b * param_stride;  // my system's pi and logw
  sched += static_cast<size_t>(b) * sched_stride;
  // ring: pm_ring[stage][child][C][NS][NS], tip_ring[stage][child][NS][T]
  float* pm_ring = smem;
  float* tip_ring = pm_ring + 4 * mat;
  // slots[C][n_slots][NS + 1][T]; row NS holds the log2 scale
  float* slots = tip_ring + 4 * NS * T;
  float* red = slots + static_cast<size_t>(C) * n_slots * kSlot;
  float* my = slots + c * n_slots * kSlot + lp;
  auto slot = [&](int s) { return my + s * kSlot; };

  // The block checks the schedule once, a row per thread, before it
  // walks it: a row whose slots or nodes lie outside the launch traps.
  // (Checked per step instead, the check cost 11 % at DNA B=65, whose
  // steps are short, and 10-18 % more where it waited on the row.)
  {
    const unsigned n_tip = n_nodes - n_int, n_child = n_nodes - 1,
                   n_slot = n_slots;
    bool bad = false;
    for (int i = tid; i < n_int; i += nthr)
      bad |= schedule_row_bad(sched, i, n_tip, n_child, n_slot);
    if (__syncthreads_or(bad)) __trap();
  }

  // step i of the schedule, held in registers and loaded two steps
  // ahead of its compute (the copies' memory clobbers would otherwise
  // make every use reload it, on the step's critical path)
  auto load_step = [&](int i, int (&st)[7]) {
    if (i < n_int) {
#pragma unroll
      for (int k = 0; k < 7; ++k) st[k] = sched[7 * i + k];
    }
  };
  // issue the copies of a step's operands into ring half `stage`
  auto fetch = [&](const int (&st)[7], int stage) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      copy_block16(pm_ring + (2 * stage + k) * mat,
                   pm_b + static_cast<size_t>(st[3 * k]) * mat, mat, tid,
                   nthr);
      if (st[3 * k + 1])
        copy_tip_rows<NS>(tip_ring + (2 * stage + k) * NS * T,
                          tips + static_cast<size_t>(st[3 * k]) * NS * P,
                          p0, P, T, tid, nthr);
    }
    cp_async_commit();
  };

  int cur[7], nxt[7], later[7];
  load_step(0, cur);
  load_step(1, nxt);
  fetch(cur, 0);
  for (int i = 0; i < n_int; ++i) {
    const int stage = i & 1;
    cp_async_wait<0>();  // this thread's copies of step i have landed
    __syncthreads();     // ... and every thread's; step i-1 is done, so
                         // ring half stage^1 is free
    if (i + 1 < n_int) fetch(nxt, stage ^ 1);
    load_step(i + 2, later);

    float acc[2][R][Q];
    float s[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) s[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* x;
      if (cur[3 * k + 1]) {
        x = tip_ring + (2 * stage + k) * NS * T + lp;
      } else {
        x = slot(cur[3 * k + 2]);
        float sk[Q];
        load_q<Q>(x + NS * T, sk);
#pragma unroll
        for (int j = 0; j < Q; ++j) s[j] += sk[j];
      }
      tile_matmul<NS, R, Q>(
          pm_ring + (2 * stage + k) * mat + (c * NS + g * R) * NS, x, T,
          acc[k]);
    }
    // combine, then rescale each column by an exact power of two
    float f[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      float m = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[0][r][j] *= acc[1][r][j];
        m = r ? fmaxf(m, acc[0][r][j]) : acc[0][r][j];
      }
      m = fmaxf(column_max<G>(m), FLT_MIN);
      const int e = (__float_as_int(m) >> 23) & 0xFF;
      f[j] = __int_as_float((254 - e) << 23);
      s[j] += static_cast<float>(e - 127);
    }
    __syncwarp();  // every lane has read this step's child slots
    float* d = slot(cur[6]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float y[Q];
#pragma unroll
      for (int j = 0; j < Q; ++j) y[j] = acc[0][r][j] * f[j];
      store_q<Q>(d + (g * R + r) * T, y);
    }
    if (g == 0) store_q<Q>(d + NS * T, s);
    if (i + 1 < n_int) {
#pragma unroll
      for (int k = 0; k < 7; ++k) cur[k] = nxt[k], nxt[k] = later[k];
    }
  }

  // root: sum_x pi * clv (each lane reads back the states it wrote),
  // then log-sum-exp over classes
  const float* x = slot(cur[6]);
  const float* pi_c = pi + (static_cast<size_t>(bp) * C + c) * NS + g * R;
  float l[Q];
#pragma unroll
  for (int j = 0; j < Q; ++j) l[j] = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v[Q];
    load_q<Q>(x + (g * R + r) * T, v);
#pragma unroll
    for (int j = 0; j < Q; ++j) l[j] += pi_c[r] * v[j];
  }
  float sc[Q];
  load_q<Q>(x + NS * T, sc);
  const float lw = logw[bp * C + c];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    l[j] = column_sum<G>(l[j]);
    if (g == 0)
      red[c * T + lp + j] = lw + sc[j] * kLn2 + logf(fmaxf(l[j], FLT_MIN));
  }
  __syncthreads();
  float* out_b = out + static_cast<size_t>(b) * P;
  for (int t = tid; t < T && p0 + t < P; t += nthr)
    out_b[p0 + t] = class_lse(red + t, C, T);
}

template <int NS>
size_t batched_smem(int C, int n_slots) {
  constexpr size_t T = kTile<NS>;
  return (4 * static_cast<size_t>(C) * NS * NS + 4 * NS * T +
          (static_cast<size_t>(n_slots) * (NS + 1) + 1) * C * T) *
         sizeof(float);
}

template <int NS>
int launch_batched(const int* sched, const float* tips, const float* pmats,
                   const float* pi, const float* logw, float* out,
                   int n_otu, int n_int, int n_slots, int C, int P, int B,
                   int sched_stride, int param_stride, cudaStream_t stream) {
  constexpr int T = kTile<NS>;
  const int tiles = (P + T - 1) / T;
  const size_t smem = batched_smem<NS>(C, n_slots);
  if (smem > kMaxSmem || tiles > 65535) return kUnsupported;
  cudaError_t err = allow_smem(batched_uppass_kernel<NS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, C), grid(B, tiles);
  batched_uppass_kernel<NS><<<grid, block, smem, stream>>>(
      sched, tips, pmats, pi, logw, out, n_otu + n_int, n_int, n_slots, P,
      sched_stride, param_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int occupancy(int C, int n_slots, int* blocks_per_sm) {
  const size_t smem = batched_smem<NS>(C, n_slots);
  if (smem > kMaxSmem) return kUnsupported;
  cudaError_t err = allow_smem(batched_uppass_kernel<NS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, batched_uppass_kernel<NS>, 32 * C, smem));
}

}  // namespace phyml

extern "C" int phyml_batched_uppass(const int* sched, const float* tips,
                                    const float* pmats, const float* pi,
                                    const float* logw, float* out, int n_otu,
                                    int n_int, int n_slots, int ns, int C,
                                    int P, int B, int per_entry_sched,
                                    int shared_params, void* stream) {
  if (C < 1 || C > 32 || B < 1 || B > 65535 || n_slots < 1)
    return phyml::kUnsupported;
  // ints between two entries' schedules; systems between two entries'
  const int sched_stride = per_entry_sched ? 7 * n_int : 0;
  const int param_stride = shared_params ? 0 : 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 4:
      return phyml::launch_batched<4>(sched, tips, pmats, pi, logw, out,
                                      n_otu, n_int, n_slots, C, P, B,
                                      sched_stride, param_stride, st);
    case 20:
      return phyml::launch_batched<20>(sched, tips, pmats, pi, logw, out,
                                       n_otu, n_int, n_slots, C, P, B,
                                       sched_stride, param_stride, st);
    default:
      return phyml::kUnsupported;
  }
}

// The blocks of K3 (32 * C threads each) one SM holds at (ns, C,
// n_slots), as the runtime grants them.
extern "C" int phyml_batched_uppass_occupancy(int ns, int C, int n_slots,
                                              int* blocks_per_sm) {
  if (C < 1 || C > 32 || n_slots < 1) return phyml::kUnsupported;
  switch (ns) {
    case 4:
      return phyml::occupancy<4>(C, n_slots, blocks_per_sm);
    case 20:
      return phyml::occupancy<20>(C, n_slots, blocks_per_sm);
    default:
      return phyml::kUnsupported;
  }
}
