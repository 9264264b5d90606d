// K1 and K4: one Felsenstein pass over the Sethi-Ullman slot schedule
// for a single parameter set, the variable-rate site lnL; one kernel
// body for both.
//
// Replaces phyml_tpu/ops/pallas_clv_slots.py:_slot_kernel (K1, wrapper
// uppass_site_lse_slots) and _slot_stream_kernel (K4, wrapper
// uppass_site_lse_slots_stream).  Per site pattern p it computes
//
//   lse[p] = logsumexp_c( logw[c] + ln2 * sc_root[c, p]
//              + log max(FLT_MIN, sum_x pi[c, x] clv_root[c, x, p]) )
//
// with the exact power-of-two rescale of common.cuh and full FP32.  The
// host builds the schedule (ops/clv_slots.py:build_slot_schedule): a
// heavy-child-first postorder whose live partials fit n_slots slots (4
// on the bench trees, at most ceil(log2 n_otu) + 1).  K3 (clv.cu)
// computes the same function batched over parameter sets; this body is
// built for one, the host lnL and the branch-length probes.
//
// What bounds it on the H100: at 128 x 3945 amino acids, C = 4, the
// matvecs (3.3 GFLOP of FP32, 0.049 ms at the FP32 peak); at 128 x 3767
// DNA the bytes (the tips once and the P-matrices, 0.002 ms).  Both lie
// far below the 127 dependent steps of the walk, each a chain of
// shared-memory loads, FMAs, a rescale and a store, with about one warp
// per SM scheduler at the bench shapes.  The design (measured on an
// H100, PERF.md):
//
// * One pipeline per warp: a warp owns one (pattern tile, class) and
//   synchronises only with __syncwarp; the C class warps of a tile form
//   one block and meet at two barriers only, after the schedule check
//   and at the root for the class log-sum-exp (one-warp blocks whose
//   [C, P] class terms a second kernel combined were slower at DNA: the
//   second launch).
// * Register tiles (common.cuh:tile_matmul): each lane owns R states x Q
//   patterns of a column split over G = ns / R lanes, T = 32 patterns
//   a warp at ns = 4 and 20 (ns = 4: R = 4, G = 1, Q = 1; ns = 20:
//   R = 5, G = 4, Q = 4; other rungs in ladder.cuh): 472 warps at
//   128 x 3767 DNA, 496 at 128 x 3945 amino acids, C = 4.  A
//   16-pattern tile at ns = 20 (twice the warps, twice the P-matrix
//   copies and loads per FMA) was slower.
// * K1 (resident): at block start each warp copies its class's
//   P-matrices for the whole tree, (n_nodes - 1) ns^2 floats (16 KB at
//   128-taxon DNA), into shared memory with cp.async; after that copy no
//   step issues a global load for a P-matrix.
// * K4 (streamed): a class's matrices for a whole 128-taxon protein tree
//   (408 KB) do not fit, so each step's two child matrices (1.6 KB each
//   at ns = 20) stream through a per-warp cp.async ring, kSlotAhead
//   steps ahead of their use (one step ahead was slower at ns = 20).
// * Tip rows: each is read exactly once, at a step the schedule names on
//   the host, so both routes copy a step's tip rows for the warp's tile
//   into the same ring kSlotAhead steps ahead; no step waits on device
//   memory.  The tips' rows are padded to the tile
//   (ops/clv_slots.py:padded_tips; the engine holds them so), so a tile
//   row is T / 4 16-byte copies (a copy per float, at an odd pattern
//   count, was 1.7x slower at 128 x 3945 amino acids).  A step issues
//   its copies after its own loads and stores (the copies' memory
//   clobbers would hold those back).
// * The schedule stays in device memory: the block checks every row
//   once before any warp walks it (a slot outside [0, n_slots), a tip
//   outside [0, n_otu) or a node outside the tree traps, as in K3, since
//   the slots and K1's matrices index shared memory), which also brings
//   the rows into L1; each warp then loads the rows it needs a step
//   ahead into registers.
// * Partials: n_slots slots of (ns + 1) x T floats per warp (row ns the
//   column's log2 scale), the schedule's own slot count.  The root's
//   partial never leaves registers.
//
// * Other state counts: one instantiation per rung of ladder.cuh, its
//   R x Q tile from the table (T = 32 patterns up to 24 states, 16
//   above); the wrappers pad ns to the rung.
//
// Dynamic shared memory per warp (slot_warp_floats; a block holds C of
// them and C x T class terms), independent of
// the tree's size but for K1's matrices and the slot count: K1 at
// 128-taxon DNA, 4 slots: 16 KB of matrices + 3 KB of tip ring + 2.5 KB
// of slots; K4 at ns = 20: 9.6 + 15.4 KB + 2.7 KB a slot, so a block of
// C = 8 classes fits only a one-slot schedule, and the engine sends a
// pass K4's block cannot hold to K3 at B = 1
// (ops/likelihood.py:single_pass_kernel).  Registers from ptxas
// (chip_smoke.py prints them and the blocks per SM the runtime grants).
#pragma once

#include "common.cuh"
#include "big_launch.cuh"

namespace phyml {

// R states and Q patterns per lane at each rung (ladder.cuh)
template <int NS>
constexpr int kSlotRows = Rung<NS>::kSlotRows;
template <int NS>
constexpr int kSlotCols = Rung<NS>::kSlotCols;

// patterns one warp covers (32 up to 24 states, 16 above)
template <int NS>
constexpr int kSlotTile = 32 / (NS / kSlotRows<NS>) * kSlotCols<NS>;

// steps a step's tip rows (and K4's P-matrices) are copied ahead of it;
// the ring has kSlotAhead + 1 stages
constexpr int kSlotAhead = 2;

// Floats of shared memory one warp uses: P-matrices (K1: its class's
// for every child node; K4: the ring), the tip ring and the slots (a
// multiple of 4: every part starts 16-byte aligned).
template <int NS, bool kResident>
__host__ __device__ constexpr size_t slot_warp_floats(int n_nodes,
                                                      int n_slots) {
  constexpr size_t T = kSlotTile<NS>, S = kSlotAhead + 1;
  const size_t pm = kResident ? static_cast<size_t>(n_nodes - 1) * NS * NS
                              : 2 * S * NS * NS;
  return pm + 2 * S * NS * T + static_cast<size_t>(n_slots) * (NS + 1) * T;
}

// One warp's pass for class c of C over the pattern tile at p0, in its
// share `smem` of shared memory; returns in term[j] the class term of
// pattern p0 + lp + j (valid on the lanes with g == 0).
template <int NS, bool kResident>
__device__ __forceinline__ void slot_site_lse_warp(
    float* smem, const int* __restrict__ sched,
    const float* __restrict__ tips, const float* __restrict__ pmats,
    const float* __restrict__ pi, const float* __restrict__ logw, int c,
    int C, int p0, int n_otu, int n_int, int n_slots, int ldt,
    float (&term)[kSlotCols<NS>]) {
  constexpr int R = kSlotRows<NS>, G = NS / R, Q = kSlotCols<NS>;
  constexpr int T = kSlotTile<NS>;
  constexpr int D = kSlotAhead, S = D + 1;
  constexpr int M = NS * NS;         // floats of one class's P-matrix
  constexpr int kSlot = (NS + 1) * T;
  constexpr int kTipPieces = NS * T / 4;  // 16-byte pieces of a tip tile
  static_assert(T % 4 == 0 && 128 % T == 0, "a warp copies whole rows");
  const int lane = threadIdx.x;
  const int g = lane % G;        // my state group: states g*R .. g*R+R-1
  const int lp = lane / G * Q;   // my first pattern in the tile
  const int n_nodes = n_otu + n_int;
  float* pm = smem;
  float* tip_ring = pm + (kResident ? (n_nodes - 1) * M : 2 * S * M);
  float* slots = tip_ring + 2 * S * NS * T;
  if constexpr (kResident) {
    // my class's matrices of every child node; node u's at pm + u * M
    constexpr int kPieces = M / 4;
    const int n = (n_nodes - 1) * kPieces;
    for (int k = lane; k < n; k += 32) {
      const int u = k / kPieces, q = k - u * kPieces;
      cp_async16(pm + 4 * k,
                 pmats + (static_cast<size_t>(u) * C + c) * M + 4 * q);
    }
  }

  // Tip rows lie ldt floats apart, each 16-byte aligned and holding
  // whole tiles (padded_tips), so a tile row is T / 4 16-byte pieces:
  // piece lane + 32m of the [NS][T] tile sits at row lane / (T/4) +
  // m * (128 / T) (a last, partial round where NS * T / 4 is not a
  // multiple of 32, ns = 60).
  const size_t tip_lane =
      static_cast<size_t>(lane / (T / 4)) * ldt + p0 + 4 * (lane % (T / 4));
  // row i of the schedule (7 ints: child0 id, is tip, slot, child1 id,
  // is tip, slot, destination slot) into registers
  auto load_row = [&](int i, int (&r)[7]) {
    if (i < n_int) {
#pragma unroll
      for (int k = 0; k < 7; ++k) r[k] = sched[7 * i + k];
    }
  };
  // issue the copies of step t's operands (row r) into ring stage t % S
  // (one commit group per step, possibly empty; K1's matrices join step
  // 0's).  Issued at the end of step t - D, it refills the stage of step
  // t - D - 1, which every lane of the warp has finished reading.
  auto fetch = [&](int t, const int (&r)[7]) {
    if (t < n_int) {
      const int stage = static_cast<unsigned>(t) % S;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int id = r[3 * k];
        if constexpr (!kResident) {
          float* dst = pm + (2 * stage + k) * M;
          const float* src = pmats + (static_cast<size_t>(id) * C + c) * M;
#pragma unroll
          for (int m = 0; m < (M / 4 + 31) / 32; ++m)
            if (lane + 32 * m < M / 4)
              cp_async16(dst + 4 * (lane + 32 * m),
                         src + 4 * (lane + 32 * m));
        }
        if (r[3 * k + 1]) {
          float* dst = tip_ring + (2 * stage + k) * NS * T;
          const float* src =
              tips + static_cast<size_t>(id) * NS * ldt + tip_lane;
#pragma unroll
          for (int m = 0; m < (kTipPieces + 31) / 32; ++m)
            if (lane + 32 * m < kTipPieces)
              cp_async16(dst + 4 * lane + 128 * m,
                         src + m * (128 / T) * static_cast<size_t>(ldt));
        }
      }
    }
    cp_async_commit();
  };

  int nx[7], fx[7];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    load_row(j, fx);
    fetch(j, fx);
  }
  // the rows of the next step and of the step the next copies are for,
  // loaded a step ahead: no copy or step waits on a schedule load
  load_row(0, nx);
  load_row(D, fx);
  float acc[2][R][Q], s[Q];
  for (int t = 0; t < n_int; ++t) {
    cp_async_wait<D - 1>();  // my copies of step t have landed
    __syncwarp();            // ... and my warp's, with the slot stores of
                             // step t-1
    int st[7], ft[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) st[k] = nx[k], ft[k] = fx[k];
    load_row(t + 1, nx);
    load_row(t + D + 1, fx);
    const int stage = static_cast<unsigned>(t) % S;
#pragma unroll
    for (int j = 0; j < Q; ++j) s[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* x;
      if (st[3 * k + 1]) {
        x = tip_ring + (2 * stage + k) * NS * T + lp;
      } else {
        x = slots + st[3 * k + 2] * kSlot + lp;
        float sk[Q];
        load_q<Q>(x + NS * T, sk);
#pragma unroll
        for (int j = 0; j < Q; ++j) s[j] += sk[j];
      }
      const float* pk = kResident ? pm + st[3 * k] * M
                                  : pm + (2 * stage + k) * M;
      tile_matmul<NS, R, Q>(pk + g * R * NS, x, T, acc[k]);
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[0][a][j] *= acc[1][a][j];
    rescale_tile<G, R, Q>(acc[0], s);
    if (t + 1 < n_int) {  // the root's partial stays in registers
      __syncwarp();       // every lane has read this step's child slots
      float* d = slots + st[6] * kSlot + lp;
#pragma unroll
      for (int a = 0; a < R; ++a) store_q<Q>(d + (g * R + a) * T, acc[0][a]);
      if (g == 0) store_q<Q>(d + NS * T, s);
    }
    // issued after the step's own loads and stores, which the copies'
    // memory clobbers would otherwise hold back
    fetch(t + D, ft);
  }
  cp_async_wait<0>();

  // root: sum_x pi * clv over my states, then over the column's G lanes
  const float* pi_c = pi + c * NS + g * R;
  const float lw = logw[c];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    float l = 0.0f;
#pragma unroll
    for (int a = 0; a < R; ++a) l += pi_c[a] * acc[0][a][j];
    l = column_sum<G>(l);
    term[j] = lw + s[j] * kLn2 + logf(fmaxf(l, FLT_MIN));
  }
}

// The kernel of one route: a block of C warps (threadIdx.y = class) per
// pattern tile, each warp on its own share of shared memory, then the
// class log-sum-exp of the tile's patterns after one barrier.
template <int NS, bool kResident>
__device__ __forceinline__ void slot_site_lse_body(
    const int* __restrict__ sched, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ pi,
    const float* __restrict__ logw, float* __restrict__ out, int n_otu,
    int n_int, int n_slots, int C, int P, int ldt) {
  constexpr int G = NS / kSlotRows<NS>, Q = kSlotCols<NS>;
  constexpr int T = kSlotTile<NS>;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x, wy = threadIdx.y, W = blockDim.y;
  const int lp = lane / G * Q, p0 = blockIdx.x * T;
  const size_t wf = slot_warp_floats<NS, kResident>(n_otu + n_int, n_slots);
  float* red = smem + W * wf;  // [C][T] class terms
  {
    // the block checks the schedule once, a row per thread, before any
    // warp walks it
    bool bad = false;
    for (int i = wy * 32 + lane; i < n_int; i += 32 * W)
      bad |= schedule_row_bad(sched, i, n_otu, n_otu + n_int - 1, n_slots);
    if (__syncthreads_or(bad)) __trap();
  }
  // one pass for my class
  {
    const int c = wy;
    float term[Q];
    slot_site_lse_warp<NS, kResident>(smem + wy * wf, sched, tips, pmats,
                                      pi, logw, c, C, p0, n_otu, n_int,
                                      n_slots, ldt, term);
    if (lane % G == 0)
#pragma unroll
      for (int j = 0; j < Q; ++j) red[c * T + lp + j] = term[j];
  }
  __syncthreads();
  for (int t = wy * 32 + lane; t < T && p0 + t < P; t += 32 * W)
    out[p0 + t] = class_lse(red + t, C, T);
}

template <int NS, bool kResident>
size_t slot_smem(int C, int n_nodes, int n_slots) {
  return (C * slot_warp_floats<NS, kResident>(n_nodes, n_slots) +
          static_cast<size_t>(C) * kSlotTile<NS>) *
         sizeof(float);
}

template <int NS, bool kResident, typename K>
int launch_slot(K* kernel, const int* sched, const float* tips,
                const float* pmats, const float* pi, const float* logw,
                float* out, int n_otu, int n_int, int n_slots, int C, int P,
                int ldt, cudaStream_t stream) {
  constexpr int T = kSlotTile<NS>;
  const size_t smem = slot_smem<NS, kResident>(C, n_otu + n_int, n_slots);
  // tip rows padded to whole tiles, each 16-byte aligned (padded_tips)
  const bool padded = ldt % 4 == 0 && ldt >= (P + T - 1) / T * T &&
                      reinterpret_cast<uintptr_t>(tips) % 16 == 0;
  if (smem > kMaxSmem || !padded) return kUnsupported;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(P + T - 1) / T, dim3(32, C), smem,
           stream>>>(sched, tips, pmats, pi, logw, out, n_otu, n_int,
                     n_slots, C, P, ldt);
  return static_cast<int>(cudaGetLastError());
}

template <int NS, bool kResident, typename K>
int slot_occupancy(K* kernel, int C, int n_otu, int n_slots,
                   int* blocks_per_sm) {
  const size_t smem = slot_smem<NS, kResident>(C, 2 * n_otu - 1, n_slots);
  if (smem > kMaxSmem) return kUnsupported;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, 32 * C, smem));
}

}  // namespace phyml

// One extern "C" launcher and one occupancy query per route, a case per
// rung of ladder.cuh and, past its top, K4's big body (big_slots.cu: a
// state count padded to a multiple of 16) for both routes (-1 for
// another ns, more than 32 classes, tip rows not padded to whole tiles,
// or a shape whose shared memory does not fit a block).  The including
// file defines PHYML_SLOT_KERNEL (its kernel template) and
// PHYML_SLOT_RESIDENT (true for K1) first.
#define PHYML_SLOT_CASE(NS, ...)                                           \
  case NS:                                                                 \
    return phyml::launch_slot<NS, PHYML_SLOT_RESIDENT>(                    \
        PHYML_SLOT_KERNEL<NS>, sched, tips, pmats, pi, logw, out, n_otu,   \
        n_int, n_slots, C, P, ldt, st);
#define PHYML_SLOT_OCC_CASE(NS, ...)                                       \
  case NS:                                                                 \
    return phyml::slot_occupancy<NS, PHYML_SLOT_RESIDENT>(                 \
        PHYML_SLOT_KERNEL<NS>, C, n_otu, n_slots, blocks_per_sm);
#define PHYML_SLOT_ENTRY(FN)                                                \
  extern "C" int FN(const int* sched, const float* tips, const float* pmats, \
                    const float* pi, const float* logw, float* out,          \
                    int n_otu, int n_int, int n_slots, int ns, int C, int P, \
                    int ldt, void* stream) {                                 \
    if (C < 1 || C > 32 || n_int < 1 || n_slots < 1)                         \
      return phyml::kUnsupported;                                            \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);               \
    switch (ns) {                                                            \
      PHYML_LADDER(PHYML_SLOT_CASE)                                          \
      default: /* past the ladder: K4's big body (big_slots.cu) */           \
        return phyml::big_pass_launch(false, sched, tips, pmats, pi, logw,   \
                                      out, n_otu, n_int, n_slots, ns, C, P,  \
                                      ldt, 1, 0, 0, st);                     \
    }                                                                        \
  }                                                                          \
  extern "C" int FN##_occupancy(int ns, int C, int n_otu, int n_slots,       \
                                int* blocks_per_sm) {                        \
    if (C < 1 || C > 32 || n_otu < 2 || n_slots < 1)                         \
      return phyml::kUnsupported;                                            \
    switch (ns) {                                                            \
      PHYML_LADDER(PHYML_SLOT_OCC_CASE)                                      \
      default:                                                               \
        return phyml::big_pass_occupancy(false, ns, C, n_slots,              \
                                         blocks_per_sm);                     \
    }                                                                        \
  }
