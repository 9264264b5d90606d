// K3 and K4 (with K1's entry) past the ladder: one Felsenstein pass over
// the Sethi-Ullman slot schedule, the variable-rate site lnL, for any
// state count past the ladder's top rung (big.cuh gives the design and
// what bounds it).
//
// Replaces, past the top rung, phyml_tpu/ops/pallas_clv.py:_uppass_kernel
// (K3: kernel big_uppass_kernel, grid (tiles, B x C), entry b its own
// parameter set, or its own tree: sched_stride / param_stride as in
// clv.cu) and phyml_tpu/ops/pallas_clv_slots.py:_slot_stream_kernel (K4:
// big_slot_kernel, B = 1; the K1 entry, _slot_kernel's, launches it
// too, since no tree's resident matrices fit a warp past the top rung).
// Both compute, per pattern p (and entry b),
//
//   lse[p] = logsumexp_c( logw[c] + ln2 * sc_root[c, p]
//              + log max(FLT_MIN, sum_x pi[c, x] clv_root[c, x, p]) )
//
// with the exact power-of-two rescale and FP32's precision (3xTF32
// products), the function of clv.cu and slots.cuh.
//
// The design: a block holds one tile of T patterns (big_pass_tile: 32,
// or 16 where 32 would leave one block an SM), T / kBigWarpCols warps on
// its columns and a warp that stages the ring.  With up to
// kBigClusterMax classes a block takes one class, the C blocks of a tile
// (and entry) one cluster, grid (tiles, B x C); with more, a block walks
// the classes in turn, grid (tiles, B).  The ring stages P_0 and P_1 of each step, step after
// step.  Each warp, on its own columns, with no block barrier:
//
//   1. y = (P_0 x_0) * (P_1 x_1) m-tile by m-tile (big_walk), each
//      m-tile's y stored unscaled and its column maxima kept: into the
//      destination slot, or, where the destination is an internal
//      child's slot (which the walk still reads), into the other child's
//      tip tile (free: that child is not a tip);
//   2. each column's factor from its maximum (shuffles), the column
//      scaled into the destination slot and the log2 scale beside it; at
//      the root, the class term of the column instead;
//   3. the next step's tip rows copied into the tip tiles by cp.async
//      (asked of L1 at the step's start), waited for at the next step.
//
// At the end the cluster's first block reads the other classes' terms
// from their shared memory and writes the site lse.
//
// Shared memory (big_pass_smem, floats): the mbarriers, the ring
// kBigStages x 2 plain pieces, the schedule's n_slots slots of T x
// (NSp + 4) + T (the log2 scales last), two tip tiles 2 x T x (NSp + 4)
// and C x T class terms: at 80 states, 7 slots, C = 4 and T = 32,
// 113 KB (two blocks an SM); at 160 states, 7 slots, T = 16, 110 KB.
// Each block checks every schedule row once and traps on a slot or node
// outside the launch.
#include <cooperative_groups.h>

#include "big.cuh"

namespace phyml {

// walk w of the pass: step w % n_int of class c0 + w / n_int, its two
// children's P-matrices
struct BigPassDesc {
  const int* sched;
  const float* pm;
  int n_int, C, c0;
  size_t M;
  __device__ __forceinline__ BigWalk operator()(int w) const {
    const int q = w / n_int, t = w - q * n_int, c = c0 + q;
    BigWalk k;
    k.nj = 2;
    k.m[0] = pm + (static_cast<size_t>(sched[7 * t]) * C + c) * M;
    k.m[1] = pm + (static_cast<size_t>(sched[7 * t + 3]) * C + c) * M;
    return k;
  }
};

__device__ __forceinline__ void big_pass_body(
    const int* __restrict__ sched, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ pi,
    const float* __restrict__ logw, float* __restrict__ out, int n_otu,
    int n_int, int n_slots, int NSp, int C, int P, int ldt,
    int sched_stride, int param_stride, int split) {
  extern __shared__ __align__(16) float smem[];
  // W warps on the tile's columns, and warp W, which stages the ring
  const int lane = threadIdx.x, wy = threadIdx.y, W = blockDim.y - 1;
  const int tid = wy * 32 + lane, nthr = 32 * (W + 1);
  const int T = W * kBigWarpCols, pw = wy * kBigWarpCols;
  // grid.x the tiles (the blocks that read the same matrices run
  // together); split: grid.y is (entry, class), a cluster the C classes
  // of one entry and tile, this block class c_lo; else grid.y the entries
  const int b = split ? blockIdx.y / C : blockIdx.y, p0 = blockIdx.x * T;
  const int c_lo = split ? blockIdx.y - b * C : 0, c_hi = split ? c_lo + 1 : C;
  const int n_nodes = n_otu + n_int, LDk = NSp + kBigPadN;
  const size_t M = static_cast<size_t>(NSp) * NSp;
  const int kSlot = T * LDk + T;  // a slot: T rows, then T log2 scales
  const float* pm_b = pmats + static_cast<size_t>(b) * n_nodes * C * M;
  const int bp = b * param_stride;
  sched += static_cast<size_t>(b) * sched_stride;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // full, empty
  float* ring = smem + kBigBarFloats;             // [S][2 pieces]
  float* slots = ring + kBigStages * 2 * kBigPieceN;
  float* tip_t = slots + static_cast<size_t>(n_slots) * kSlot;  // [2][T][LDk]
  float* red = tip_t + 2 * T * LDk;                             // [C][T]
  if (tid == 0) big_ring_init(bars, W);
  {
    bool bad = false;
    for (int i = tid; i < n_int; i += nthr)
      bad |= schedule_row_bad(sched, i, n_otu, n_nodes - 1, n_slots);
    if (__syncthreads_or(bad)) __trap();  // also: the barriers are set
  }
  BigRing<BigPassDesc> rg{ring, bars, bars + kBigStages, 2 * kBigPieceN,
                          NSp, (NSp + kBigChunk - 1) / kBigChunk,
                          (c_hi - c_lo) * n_int,
                          BigPassDesc{sched, pm_b, n_int, C, c_lo, M}};
  namespace cg = cooperative_groups;
  if (wy == W) {
    rg.run();
    if (split) {  // the cluster's two barriers below
      cg::this_cluster().sync();
      cg::this_cluster().sync();
    }
    return;
  }
  // the column of my rescale lanes, their first row and row step
  const int cw = lane % kBigWarpCols, r0 = lane / kBigWarpCols;
  constexpr int kRowStep = 32 / kBigWarpCols;
  // the tip rows of step t into the tip tiles (my columns), in flight
  // until the step's start
  auto fetch_tips = [&](int t) {
    const int* r = sched + 7 * t;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (r[3 * k + 1])
        big_load_cols(tip_t + k * T * LDk + pw * LDk, LDk,
                      tips + static_cast<size_t>(r[3 * k]) * NSp * ldt, ldt,
                      NSp, p0 + pw, P - 1);
  };
  fetch_tips(0);

  for (int c = c_lo; c < c_hi; ++c) {
    const float* pi_c = pi + (static_cast<size_t>(bp) * C + c) * NSp;
    for (int t = 0; t < n_int; ++t) {
      cp_async_wait<0>();  // my copies of this step's tip rows ...
      __syncwarp();        // ... and my warp's
      int r[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) r[k] = sched[7 * t + k];
      // the next step's row (the first of the next class after the
      // root), or none
      const int nt = t + 1 < n_int ? t + 1 : (c + 1 < c_hi ? 0 : -1);
      if (nt >= 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (sched[7 * nt + 3 * k + 1])
            big_prefetch_rows(
                tips + static_cast<size_t>(sched[7 * nt + 3 * k]) * NSp * ldt,
                ldt, NSp, min(p0 + pw, P - 1));
      }
      const float* x[2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        x[k] = r[3 * k + 1] ? tip_t + k * T * LDk : slots + r[3 * k + 2] * kSlot;
      float* dst = slots + r[6] * kSlot;
      // where the unscaled product goes while the walk still reads the
      // children: the destination, or the tip tile of the child whose
      // slot it is
      float* ybuf = !r[1] && r[2] == r[6]   ? tip_t
                    : !r[4] && r[5] == r[6] ? tip_t + T * LDk
                                            : dst;
      float* yw = ybuf + pw * LDk;
      float cm[kBigNT][2] = {};
      const float* xw[2] = {x[0] + pw * LDk, x[1] + pw * LDk};
      big_walk<2>(rg, xw, LDk, [&](int mt, float (&acc)[2][kBigNT][4]) {
        float y[kBigNT][4];
#pragma unroll
        for (int n = 0; n < kBigNT; ++n)
#pragma unroll
          for (int q = 0; q < 4; ++q) y[n][q] = acc[0][n][q] * acc[1][n][q];
        big_store_frag(yw, LDk, mt * kBigPanel, y, cm);
      });
      // the children's log2 scales of column cw, before any store to dst
      float sc = 0.0f;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (!r[3 * k + 1]) sc += x[k][T * LDk + pw + cw];
      const float f = big_factor(big_colmax(cm, cw), &sc);
      __syncwarp();  // every lane's y is stored
      const float* yc = yw + cw * LDk;
      if (t + 1 < n_int) {
        float* dc = dst + (pw + cw) * LDk;
        for (int rr = r0; rr < NSp; rr += kRowStep) dc[rr] = yc[rr] * f;
        if (r0 == 0) dst[T * LDk + pw + cw] = sc;
      } else {
        // the root: sum_x pi * clv over every state of column cw
        float l = 0.0f;
        for (int rr = r0; rr < NSp; rr += kRowStep) l += pi_c[rr] * (yc[rr] * f);
#pragma unroll
        for (int o = kBigWarpCols; o < 32; o <<= 1)
          l += __shfl_xor_sync(0xffffffffu, l, o);
        if (r0 == 0)
          red[c * T + pw + cw] =
              logw[bp * C + c] + sc * kLn2 + logf(fmaxf(l, FLT_MIN));
      }
      __syncwarp();  // the tip tiles are read; dst is whole
      if (nt >= 0) fetch_tips(nt);
    }
  }
  // my columns' class terms are my lanes' own; split, the cluster's
  // first block gathers the others' from their shared memory, which
  // stays until the second barrier
  const bool put = r0 == 0 && p0 + pw + cw < P;
  if (split) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (c_lo == 0 && put) {
      for (int c = 1; c < C; ++c)
        red[c * T + pw + cw] = cl.map_shared_rank(red, c)[c * T + pw + cw];
      out[static_cast<size_t>(b) * P + p0 + pw + cw] =
          class_lse(red + pw + cw, C, T);
    }
    cl.sync();
  } else if (put) {
    out[static_cast<size_t>(b) * P + p0 + pw + cw] =
        class_lse(red + pw + cw, C, T);
  }
}

__global__ void __launch_bounds__(32 * (kBigMaxWarps + 1))
    big_uppass_kernel(const int* __restrict__ sched,
                      const float* __restrict__ tips,
                      const float* __restrict__ pmats,
                      const float* __restrict__ pi,
                      const float* __restrict__ logw, float* __restrict__ out,
                      int n_otu, int n_int, int n_slots, int NSp, int C, int P,
                      int ldt, int sched_stride, int param_stride,
                      int split) {
  big_pass_body(sched, tips, pmats, pi, logw, out, n_otu, n_int, n_slots,
                NSp, C, P, ldt, sched_stride, param_stride, split);
}

__global__ void __launch_bounds__(32 * (kBigMaxWarps + 1))
    big_slot_kernel(const int* __restrict__ sched,
                    const float* __restrict__ tips,
                    const float* __restrict__ pmats,
                    const float* __restrict__ pi,
                    const float* __restrict__ logw, float* __restrict__ out,
                    int n_otu, int n_int, int n_slots, int NSp, int C, int P,
                    int ldt, int sched_stride, int param_stride,
                    int split) {
  big_pass_body(sched, tips, pmats, pi, logw, out, n_otu, n_int, n_slots,
                NSp, C, P, ldt, sched_stride, param_stride, split);
}

// bytes of shared memory of one block of tile T (the layout of
// big_pass_body)
size_t big_pass_smem(int NSp, int C, int n_slots, int T) {
  const size_t LDk = NSp + kBigPadN;
  return (kBigBarFloats + kBigStages * 2 * kBigPieceN +
          static_cast<size_t>(n_slots) * (T * LDk + T) + 2 * T * LDk +
          static_cast<size_t>(C) * T) *
         sizeof(float);
}

// the tile: 32 patterns where the block then leaves two blocks an SM
int big_pass_tile(int NSp, int C, int n_slots) {
  return big_pass_smem(NSp, C, n_slots, kBigTileWide) <= kBigTwoBlocks
             ? kBigTileWide
             : kBigTileNarrow;
}

int big_pass_launch(bool batched, const int* sched, const float* tips,
                    const float* pmats, const float* pi, const float* logw,
                    float* out, int n_otu, int n_int, int n_slots, int NSp,
                    int C, int P, int ldt, int B, int sched_stride,
                    int param_stride, cudaStream_t stream) {
  if (!big_width(NSp)) return kUnsupported;
  const int T = big_pass_tile(NSp, C, n_slots);
  const int tiles = (P + T - 1) / T;
  const size_t smem = big_pass_smem(NSp, C, n_slots, T);
  const int rows = C > kBigClusterMax ? B : B * C;  // grid.y
  if (smem > kMaxSmem || rows > 65535 || ldt < P) return kUnsupported;
  auto* kernel = batched ? big_uppass_kernel : big_slot_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, T / kBigWarpCols + 1);
  if (C > kBigClusterMax) {
    kernel<<<dim3(tiles, B), block, smem, stream>>>(
        sched, tips, pmats, pi, logw, out, n_otu, n_int, n_slots, NSp, C, P,
        ldt, sched_stride, param_stride, 0);
    return static_cast<int>(cudaGetLastError());
  }
  // a block a class, the C blocks of an entry and tile one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, B * C);
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = C;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, sched, tips, pmats, pi, logw, out,
                           n_otu, n_int, n_slots, NSp, C, P, ldt,
                           sched_stride, param_stride, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int big_pass_occupancy(bool batched, int NSp, int C, int n_slots,
                       int* blocks_per_sm) {
  if (!big_width(NSp)) return kUnsupported;
  const int T = big_pass_tile(NSp, C, n_slots);
  const size_t smem = big_pass_smem(NSp, C, n_slots, T);
  if (smem > kMaxSmem) return kUnsupported;
  auto* kernel = batched ? big_uppass_kernel : big_slot_kernel;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, (T / kBigWarpCols + 1) * 32, smem));
}

}  // namespace phyml
