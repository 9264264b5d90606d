// The FFMA walk of K5's big body (big_edotp.cu, with K2's entry) past
// the ladder's top rung; K3/K4's body runs the 3xTF32 walk of big.cuh,
// whose padded state count (kBigPanel), big_width, mbarriers and
// column factor it shares.
//
// Why K5 keeps FFMA, and in this order: its edge terms come out of
// eigen-basis sums, V^T o and V^-1 x, whose terms cancel, so two
// float32 sums that round apart differ by ~3e-3 in a site's edge term
// at 80 and 160 states.  Every output of every product (P x, P^T o,
// V^T o, V^-1 x) here is one float32 accumulator that starts at 0 and
// adds its terms by FFMA, k ascending from 0 to NSp - 1, as the plain
// version's float32 GEMMs do, and agrees with them to the bit; no split
// over k, no tensor cores, no fast math.  Padded states sit at the end
// of k and add exact zeros.  A 3xTF32 walk (tensor cores, which round
// their sums toward zero) stood 3.3e-3 to 8.2e-3 from the plain version
// there, past the edge-term tolerance of 2e-3 (chip_smoke.py: EDGE_TOL;
// PERF.md), and tests/test_torch_tf32split.py shows why on the CPU.
//
// The design:
//
// * Warps over patterns: a block holds W <= kFfmaMaxWarps warps on its
//   columns, kFfmaWarpCols = 16 patterns each, and one warp that stages
//   the ring.  A warp owns its 16 columns and every output state of
//   them, so a rescale's column maximum is the warp's own (shuffles):
//   no block barrier after the start.  Each warp copies its own operand
//   tiles and meets only itself (__syncwarp).
// * Lane tiles of 4 states x 4 patterns: lane = 16 h + 4 rg + cg owns
//   states 32 mp + 16 h + 4 rg .. + 3 of m-tile pair mp and patterns
//   4 cg .. + 3, so a warp computes 32 output states x 16 patterns at a
//   time; 16 FFMA per 16-byte load of the matrix and one of the
//   operand (a 4 x 2 tile had 8 FFMA per 16 + 8 bytes).  Where NSp / 16
//   is odd the last pair holds 16 states: the lanes of h = 1 repeat
//   h = 0's (the same addresses, a broadcast) and store nothing.
// * Matrices staged once for the block: the staging warp copies each
//   walk's pieces (one m-tile pair by 16 contraction states of up to
//   two matrices) by cp.async into kFfmaStages stages, an mbarrier a
//   stage for "landed" (cp.async.mbarrier.arrive of its 32 lanes) and
//   one for "read by every warp" (one arrive a warp).  The ring runs
//   across steps, so the next step's matrices land while this step
//   computes.
// * V and V^-1 resident for the block's class where the block then
//   still leaves two blocks an SM (kBigTwoBlocks: 48 and 64 states);
//   else they stream through the ring with the P-matrices, since two
//   blocks of four warps an SM were worth more than residency.
// * Bank-conflict-free reads: a piece read as [out][k] (P x, V^-1 x) has
//   16-float rows, row r at r ^ (r >> 4 & 1) and its 16-byte chunks
//   XORed with r >> 2 & 3, so a load's eight row groups fall in eight
//   distinct groups of four banks; a piece read as [k][out] (P^T o,
//   V^T o) has 32-float rows that every lane reads at once.  Resident
//   V^-1 keeps its chunks' swizzle and, for the two halves of a pair,
//   the rows' (NSp 16 mod 32) or, where NSp is a multiple of 32, swaps
//   the 16-column blocks of rows r with r >> 4 odd (ffma_res_n);
//   resident V keeps its plain rows.
// * A step's operand tiles (tip rows, workspace tiles: a few KB a
//   warp) are copied when it starts; asking L2 for the next step's
//   tiles a step ahead was 1-5 % slower (PERF.md).
//
// What bounds it on the H100: FP32 FMAs, 2 NSp^2 FLOP per pattern,
// class and product, 7 products a node (2 up, 4 for d, 1 push): 1.2 ms
// at the FP32 peak at 80 states, 64 taxa x 3636 patterns, C = 4
// (PERF.md); the device memory (d, the workspace) ~0.4 ms.  As
// measured (PERF.md), the walk
// issues FFMA at ~41 % of the pipe's rate at 48, 64 and 80 states, as
// if shared memory delivered 16 bytes a lane per load whatever a load
// broadcasts (128 bytes a cycle an SM): 8 FFMA a 16-byte load need
// twice that.  Groups of two or three pairs sharing each operand load
// (12 FFMA a load) were slower: their accumulators passed the 168
// registers ptxas kept, and spilled, or left one block an SM.
#pragma once

#include "big.cuh"

namespace phyml {

constexpr int kFfmaWarpCols = 16;  // pattern columns of a warp
constexpr int kFfmaMaxWarps = 4;   // warps on a block's columns at most
constexpr int kFfmaPair = 32;      // output states of an m-tile pair
constexpr int kFfmaStages = 4;     // stages of the ring
constexpr int kFfmaItem = kFfmaPair * kBigPanel;  // floats of a piece
// floats of the two mbarrier arrays (full, empty) in front of the ring
constexpr int kFfmaBarFloats = 2 * kFfmaStages * 2;
static_assert(kFfmaWarpCols == 16 && kFfmaPair == 2 * kBigPanel,
              "a lane tile is 4 x 4 of a 32-state x 16-pattern warp tile");

// Where resident V^-1 keeps its element (r, k): rows NSp floats apart,
// the 16-byte chunks of a 16-column block XORed with r >> 2 & 3, and for
// r >> 4 odd row r ^ 1 (NSp 16 mod 32) or the 16-column block k >> 4 ^ 1
// (NSp a multiple of 32), so that two rows 16 apart lie in opposite
// halves of the banks.
__device__ __forceinline__ int ffma_res_n(int r, int k, int NSp) {
  const int odd = (r >> 4) & 1;
  const int chunk = ((k >> 2) & 3) ^ ((r >> 2) & 3);
  return NSp % 32 == 0
             ? r * NSp + (((k >> 4) ^ odd) << 4) + (chunk << 2) + (k & 3)
             : (r ^ odd) * NSp + ((k >> 4) << 4) + (chunk << 2) + (k & 3);
}

// Floats of shared memory of a block of W warps at NSp states: the
// mbarriers, the ring (stages of two pieces), resident V and V^-1 where
// `resident`, and each warp's tiles: two children's partials and the
// outside partial, (NSp + 1) x 16 each (row NSp the log2 scales), and
// the second outside partial, NSp x 16.
__host__ __device__ inline size_t ffma_smem_floats(int NSp, int W,
                                                   bool resident) {
  const size_t N = NSp;
  return kFfmaBarFloats + kFfmaStages * 2 * kFfmaItem +
         (resident ? 2 * N * N : 0) +
         static_cast<size_t>(W) * kFfmaWarpCols * (4 * N + 3);
}

// Warps of a block at NSp states: the most (<= kFfmaMaxWarps) whose
// block fits kMaxSmem with V and V^-1 streamed (0: none fits).
inline int ffma_warps(int NSp) {
  for (int W = kFfmaMaxWarps; W >= 1; --W)
    if (ffma_smem_floats(NSp, W, false) * sizeof(float) <= kMaxSmem)
      return W;
  return 0;
}

// V and V^-1 resident where the block then still leaves two blocks an SM.
inline bool ffma_resident(int NSp) {
  const int W = ffma_warps(NSp);
  return W > 0 &&
         ffma_smem_floats(NSp, W, true) * sizeof(float) <= kBigTwoBlocks;
}

// ---- the ring --------------------------------------------------------

// The mbarriers of a ring read by W warps: full[s] waits for the staging
// warp's 32 lanes, empty[s] for the W warps.  One thread.
__device__ __forceinline__ void ffma_ring_init(uint64_t* bars, int W) {
  for (int s = 0; s < kFfmaStages; ++s) {
    mbar_init(bars + s, 32);
    mbar_init(bars + kFfmaStages + s, W);
  }
}

// The staging warp's side: every piece of every walk in the order the
// reading warps walk them, each stage once its last use has been read
// by every warp.
struct FfmaStager {
  float* ring;
  uint64_t* full;
  uint64_t* empty;
  int NSp;
  int s = 0, round = 0;

  // one walk of nj <= 2 matrices (row-major NSp x NSp in device memory,
  // 16-byte aligned), matrix j read as [k][out] where bit j of trans is
  // set: its pieces, m-tile pair by pair, 16 contraction states at a time
  __device__ __forceinline__ void walk(const float* m0, const float* m1,
                                       int nj, unsigned trans) {
    const float* m[2] = {m0, m1};
    for (int mp = 0; mp < (NSp + kFfmaPair - 1) / kFfmaPair; ++mp)
      for (int kc = 0; kc < NSp / kBigPanel; ++kc)
        piece(m, nj, trans, mp, kc);
  }

  // the pieces of pair mp and contraction states 16 kc .. 16 kc + 15 of
  // the nj matrices m into the next stage
  __device__ __forceinline__ void piece(const float* const (&m)[2], int nj,
                                        unsigned trans, int mp, int kc) {
    const int lane = threadIdx.x;
    const int o0 = mp * kFfmaPair, k0 = kc * kBigPanel;
    const int rows = min(kFfmaPair, NSp - o0);  // 32, or 16 at the end
    if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
    float* st = ring + s * 2 * kFfmaItem;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j >= nj) break;
      float* dst = st + j * kFfmaItem;
      if ((trans >> j) & 1u) {
        // rows k0 .. k0 + 15, columns o0 .. o0 + rows: [k][32]
        const int nch = rows / 4;
        for (int q = lane; q < kBigPanel * nch; q += 32) {
          const int kr = q / nch, cc = q - kr * nch;
          cp_async16(dst + kr * kFfmaPair + 4 * cc,
                     m[j] + static_cast<size_t>(k0 + kr) * NSp + o0 + 4 * cc);
        }
      } else {
        // rows o0 .. o0 + rows, columns k0 .. k0 + 15, swizzled
        for (int q = lane; q < rows * 4; q += 32) {
          const int r = q >> 2, c4 = q & 3;
          cp_async16(dst + (r ^ (r >> 4)) * kBigPanel +
                         ((c4 ^ ((r >> 2) & 3)) << 2),
                     m[j] + static_cast<size_t>(o0 + r) * NSp + k0 + 4 * c4);
        }
      }
    }
    mbar_arrive_copies(full + s);
    if (++s == kFfmaStages) s = 0, ++round;
  }
};

// A reading warp's side: the stage of its next piece, once landed.
struct FfmaReader {
  const float* ring;
  uint64_t* full;
  uint64_t* empty;
  int it = 0;  // pieces this warp has read

  __device__ __forceinline__ const float* acquire() {
    const int s = it % kFfmaStages;
    mbar_wait(full + s, (it / kFfmaStages) & 1);
    return ring + s * 2 * kFfmaItem;
  }

  __device__ __forceinline__ void release() {
    __syncwarp();
    if (threadIdx.x == 0) mbar_arrive(empty + it % kFfmaStages);
    ++it;
  }
};

// ---- the walk --------------------------------------------------------

// acc[a][b] += m_a v_b, a 4 x 4 outer product by FFMA
__device__ __forceinline__ void ffma_outer(float (&acc)[4][4], float4 m,
                                           float4 v) {
  const float mm[4] = {m.x, m.y, m.z, m.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(mm[a], vv[b], acc[a][b]);
}

// The lane's 4 x 4 tile of one product over 16 contraction states.
// [k][out] (kT): ap is the lane's first output of the piece's row 0,
// rows ld floats apart.  [out][k]: ap is the lane's first row (rows ld
// floats apart, row a at a ^ rx) at the piece's first chunk, whose
// 16-byte chunks are XORed with rg.  x is the operand's first of those
// rows ([k][16] in shared memory), cg the lane's column group.  Each
// accumulator adds its 16 terms in ascending k.
template <bool kT>
__device__ __forceinline__ void ffma_piece(float (&acc)[4][4],
                                           const float* ap, int ld, int rx,
                                           const float* x, int rg, int cg) {
  if constexpr (kT) {
#pragma unroll
    for (int k = 0; k < kBigPanel; ++k)
      ffma_outer(acc, *reinterpret_cast<const float4*>(ap + k * ld),
                 *reinterpret_cast<const float4*>(x + k * 16 + 4 * cg));
  } else {
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) {
      float vb[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v = *reinterpret_cast<const float4*>(
            x + (4 * c4 + u) * 16 + 4 * cg);
        vb[u][0] = v.x, vb[u][1] = v.y, vb[u][2] = v.z, vb[u][3] = v.w;
      }
      const int off = (c4 ^ rg) << 2;
#pragma unroll
      for (int a4 = 0; a4 < 4; ++a4) {
        const float4 m =
            *reinterpret_cast<const float4*>(ap + (a4 ^ rx) * ld + off);
        const float mk[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            acc[a4][b] = fmaf(mk[u], vb[u][b], acc[a4][b]);
      }
    }
  }
}

// The warp's share of one walk of NJ products: for each m-tile pair mp
// and each of the lane's outputs, acc[j] = M_j x_j (M_j^T x_j where bit
// j of kT is set) over all NSp contraction states, then epi(mp, full,
// acc) (full: the pair holds 32 states).  x_j is the warp's operand
// tile [NSp][16] in shared memory.  M_j is read from its resident copy
// in shared memory, res[j] (V as [k][out] in plain rows, V^-1 as
// [out][k] laid out by ffma_res_n), or, where res[j] is null, from the
// ring: its next items, one per pair and 16 contraction states, in the
// order of the ring-sourced products.
template <int NJ, unsigned kT, typename Epi>
__device__ __forceinline__ void ffma_walk(FfmaReader& rd,
                                          const float* const (&res)[NJ],
                                          const float* const (&x)[NJ],
                                          int NSp, Epi&& epi) {
  const int lane = threadIdx.x;
  const int h = lane >> 4, rg = (lane >> 2) & 3, cg = lane & 3;
  const int n_mp = (NSp + kFfmaPair - 1) / kFfmaPair;
  const int n_kc = NSp / kBigPanel;
  bool ring = false;
#pragma unroll
  for (int j = 0; j < NJ; ++j) ring |= res[j] == nullptr;
  for (int mp = 0; mp < n_mp; ++mp) {
    const bool full = (mp + 1) * kFfmaPair <= NSp;
    const int hh = full ? h : 0;
    float acc[NJ][4][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[j][a][b] = 0.0f;
    for (int kc = 0; kc < n_kc; ++kc) {
      const float* st = ring ? rd.acquire() : nullptr;
      int item = 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float* xk = x[j] + kc * kBigPanel * 16;
        const float* rj = res[j];
        const float* it = rj ? nullptr : st + (item++) * kFfmaItem;
        if ((kT >> j) & 1u) {
          // [k][out]: the lane's outputs 16 hh + 4 rg .. of row 0
          const int ld = rj ? NSp : kFfmaPair;
          const float* ap =
              (rj ? rj + kc * kBigPanel * ld + mp * kFfmaPair : it) +
              16 * hh + 4 * rg;
          ffma_piece<true>(acc[j], ap, ld, 0, xk, rg, cg);
        } else if (rj) {
          // resident [out][k] (ffma_res_n)
          const int r0 = mp * kFfmaPair + 16 * hh + 4 * rg;
          const bool even = NSp % 32 == 0;
          ffma_piece<false>(
              acc[j], rj + r0 * NSp + ((even ? kc ^ hh : kc) << 4), NSp,
              even ? 0 : hh, xk, rg, cg);
        } else {
          // a staged [out][k] piece: rows 16-float, row r at r ^ (r >> 4)
          ffma_piece<false>(acc[j], it + (16 * hh + 4 * rg) * kBigPanel,
                            kBigPanel, hh, xk, rg, cg);
        }
      }
      if (ring) rd.release();
    }
    epi(mp, full, acc);
  }
}

// The column maxima cm (the lane's four patterns) over the eight lanes
// of those patterns, then each column's exact power-of-two factor
// (big_factor), its e - 127 added to s.
__device__ __forceinline__ void ffma_factors(float (&cm)[4], float (&s)[4],
                                             float (&f)[4]) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      cm[b] = fmaxf(cm[b], __shfl_xor_sync(0xffffffffu, cm[b], o));
    f[b] = big_factor(cm[b], &s[b]);
  }
}

// The warp copies a workspace tile (NSp + 1 rows of its 16 columns,
// rows ld floats apart, 16-byte aligned) into dst [NSp + 1][16].
__device__ __forceinline__ void ffma_copy_tile(float* dst, const float* src,
                                               size_t ld, int NSp) {
  for (int q = threadIdx.x; q < (NSp + 1) * 4; q += 32) {
    const int r = q >> 2, c4 = q & 3;
    cp_async16(dst + r * 16 + 4 * c4, src + r * ld + 4 * c4);
  }
}

// The warp copies one tip's rows for its 16 columns: dst[x * 16 + l] =
// row[x * ld + min(p0 + l, P - 1)] for x < NSp (the ragged edge repeats
// the last column, which is never stored), and a zero scale row.
__device__ __forceinline__ void ffma_copy_tip(float* dst, const float* row,
                                              size_t ld, int NSp, int p0,
                                              int P) {
  for (int k = threadIdx.x; k < NSp * 16; k += 32) {
    const int x = k >> 4, l = k & 15;
    cp_async4(dst + k, row + x * ld + min(p0 + l, P - 1));
  }
  if (threadIdx.x < 16) dst[NSp * 16 + threadIdx.x] = 0.0f;
}

}  // namespace phyml
