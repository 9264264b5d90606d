// The FFMA panel walk of K5's big body (big_edotp.cu, with K2's entry)
// past the ladder's top rung; K3/K4's body runs the 3xTF32 walk of
// big.cuh, whose padded state count (kBigPanel) and big_width it shares.
//
// Why K5 keeps FFMA: its edge terms come out of eigen-basis sums,
// V^T o and V^-1 x, whose terms cancel, so two float32 sums that round
// apart differ by ~3e-3 in a site's edge term at 80 and 160 states.
// This walk adds each product's terms in order, one FFMA each, as the
// plain version's float32 GEMMs do, and agrees with them to the bit;
// a 3xTF32 walk (tensor cores, which round their sums toward zero)
// stood 3.3e-3 to 8.2e-3 from them there, past the edge-term tolerance
// of 2e-3 (chip_smoke.py: EDGE_TOL; PERF.md), and
// tests/test_torch_tf32split.py shows why on the CPU.
//
// The design:
//
// * ns is padded to a multiple of a 16-state panel (kBigPanel); a
//   16 x 16 piece of a matrix is four 16-byte rows of four lanes' copies,
//   and a 16-state x 16-pattern output panel is a 4 x 2 register tile on
//   each of 32 lanes.
// * A block holds one tile of kFfmaTile = 16 patterns and W warps
//   (ffma_warps: the NSp / 16 output panels spread over at most 8 warps
//   in equal rounds; 80 states: 5 warps, 160: 5 warps of 2 panels, 240:
//   8 warps, 15 panels).  Warp w computes the output panels w, w + W,
//   ...; for each it walks the contraction axis in 16-state k-panels.
//   The 16 x 16 pieces of each matrix it needs stream through the warp's
//   own two-stage cp.async ring (2 x 16 x 16 floats a matrix), one piece
//   ahead, synchronised with __syncwarp only: no whole P-matrix is ever
//   in shared memory.  The operand tiles are shared by the block's warps.
// * The rescale is over all NSp states of a column, which lie in every
//   warp: each warp writes its panels' column maxima to a [W][16] array,
//   and after a block barrier every thread takes the maximum over the W
//   warps for its column (big_column_factor).
// * Full FP32: FFMA on the CUDA cores, no tensor cores, no fast math.
//
// What bounds it on the H100: every piece of P fed from shared memory
// gives 4 x 2 FMAs a lane per 16-byte and 8-byte load, and each step
// waits at three (up) or four (down) block barriers, so the
// shared-memory pipe and the barriers, not the FMA pipe, set its time:
// 6.2 ms at 80 states, 64 taxa x 3636 patterns, C = 4, against 1.2 ms
// at the FP32 peak (PERF.md).
#pragma once

#include "big.cuh"

namespace phyml {

constexpr int kFfmaTile = 16;     // patterns of a block's tile
constexpr int kFfmaMaxWarps = 8;  // warps of a block at most
constexpr int kFfmaPiece = kBigPanel * kBigPanel;  // floats of a piece

// Warps of a big block at NSp (padded) states: the NSp / 16 output
// panels over at most 8 warps, each warp the same number of panels or
// one fewer.
inline int ffma_warps(int NSp) {
  const int np = NSp / kBigPanel;
  const int rounds = (np + kFfmaMaxWarps - 1) / kFfmaMaxWarps;
  return (np + rounds - 1) / rounds;
}

// ---- the panel walk ------------------------------------------------
// Lane layout of a 16-state x 16-pattern output panel: lane = 8 rg + pg
// owns states 4 rg .. 4 rg + 3 and patterns 2 pg, 2 pg + 1.  Each
// quarter-warp (8 lanes) shares rg, so the 16-byte loads of a piece are
// broadcasts; the 8-byte loads of an operand tile row are 16 adjacent
// floats.

// The warp's share of NJ products over the block's output panels:
// acc[j] = M_j x_j (or M_j^T x_j where bit j of kTrans is set) for each
// output panel o = w, w + W, ... < NSp / 16, M_j a row-major NSp x NSp
// matrix in device memory (16-byte aligned) and x_j an [NSp][16]
// operand tile in shared memory.  The 16 x
// 16 pieces of the M_j stream through `ring` (the warp's 2 * NJ pieces)
// one piece ahead.  After the last k-panel of output panel o, epi(o,
// acc) sees the lane's 4 x 2 tile of each product.  Leaves one empty
// cp.async group of this thread pending.
template <int NJ, unsigned kTrans, typename Epi>
__device__ __forceinline__ void big_panels(float* ring,
                                           const float* (&m)[NJ],
                                           const float* (&x)[NJ],
                                           int NSp, int w, int W, Epi&& epi) {
  const int lane = threadIdx.x;
  const int rg = lane >> 3, pg = lane & 7;
  const int np = NSp / kBigPanel;
  const int n_items = ((np - 1 - w) / W + 1) * np;
  // item i: output panel w + (i / np) W, k-panel i % np, into stage i & 1
  auto issue = [&](int i) {
    if (i < n_items) {
      const int o = w + (i / np) * W, kp = i % np;
      float* st = ring + (i & 1) * NJ * kFfmaPiece;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        // a piece is rows r0.., columns c0.. of M_j: the output panel's
        // rows by the k-panel's columns, or transposed
        const bool tr = (kTrans >> j) & 1u;
        const int r0 = (tr ? kp : o) * kBigPanel;
        const int c0 = (tr ? o : kp) * kBigPanel;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = lane + 32 * h, r = q >> 2, c4 = q & 3;
          cp_async16(st + j * kFfmaPiece + r * kBigPanel + 4 * c4,
                     m[j] + static_cast<size_t>(r0 + r) * NSp + c0 + 4 * c4);
        }
      }
    }
    cp_async_commit();  // possibly empty: one group per item
  };
  float acc[NJ][4][2];
  __syncwarp();  // every lane is done with the ring's last use
  issue(0);
  for (int i = 0; i < n_items; ++i) {
    __syncwarp();  // every lane is done with item i - 1's stage
    issue(i + 1);
    cp_async_wait<1>();  // my copies of item i have landed
    __syncwarp();        // ... and my warp's
    const int o = w + (i / np) * W, kp = i % np;
    if (kp == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[j][a][0] = acc[j][a][1] = 0.0f;
    }
    const float* st = ring + (i & 1) * NJ * kFfmaPiece;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* pc = st + j * kFfmaPiece;
      const float* xk = x[j] + kp * kBigPanel * kFfmaTile + 2 * pg;
      if ((kTrans >> j) & 1u) {
        // piece [k][out]: the lane's 4 outputs of row k are adjacent
#pragma unroll 4
        for (int k = 0; k < kBigPanel; ++k) {
          const float4 p =
              *reinterpret_cast<const float4*>(pc + k * kBigPanel + 4 * rg);
          const float2 v = *reinterpret_cast<const float2*>(xk + k * kFfmaTile);
          acc[j][0][0] += p.x * v.x, acc[j][0][1] += p.x * v.y;
          acc[j][1][0] += p.y * v.x, acc[j][1][1] += p.y * v.y;
          acc[j][2][0] += p.z * v.x, acc[j][2][1] += p.z * v.y;
          acc[j][3][0] += p.w * v.x, acc[j][3][1] += p.w * v.y;
        }
      } else {
        // piece [out][k]: four k a 16-byte load of each output row
#pragma unroll
        for (int k4 = 0; k4 < kBigPanel; k4 += 4) {
          float2 v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            v[u] = *reinterpret_cast<const float2*>(xk + (k4 + u) * kFfmaTile);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float4 p = *reinterpret_cast<const float4*>(
                pc + (4 * rg + a) * kBigPanel + k4);
            acc[j][a][0] += p.x * v[0].x, acc[j][a][1] += p.x * v[0].y;
            acc[j][a][0] += p.y * v[1].x, acc[j][a][1] += p.y * v[1].y;
            acc[j][a][0] += p.z * v[2].x, acc[j][a][1] += p.z * v[2].y;
            acc[j][a][0] += p.w * v[3].x, acc[j][a][1] += p.w * v[3].y;
          }
        }
      }
    }
    if (kp == np - 1) epi(o, acc);
  }
}

// The lane's 4 x 2 tile y of output panel o into an [NSp][16] tile `dst`
// in shared memory, and its column maxima into cm (the lane's two
// patterns, over every panel the lane has stored).
__device__ __forceinline__ void big_store_tile(float* dst, int o,
                                               const float (&y)[4][2],
                                               float (&cm)[2]) {
  const int lane = threadIdx.x, rg = lane >> 3, pg = lane & 7;
  float* d = dst + (o * kBigPanel + 4 * rg) * kFfmaTile + 2 * pg;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    *reinterpret_cast<float2*>(d + a * kFfmaTile) = make_float2(y[a][0],
                                                               y[a][1]);
    cm[0] = fmaxf(cm[0], y[a][0]);
    cm[1] = fmaxf(cm[1], y[a][1]);
  }
}

// The warp's column maxima cm (per lane, its two patterns) over the four
// lanes of a pattern pair, into colmax[w][16] of shared memory.
__device__ __forceinline__ void big_warp_colmax(float (&cm)[2],
                                                float* colmax, int w) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    cm[q] = fmaxf(cm[q], __shfl_xor_sync(0xffffffffu, cm[q], 8));
    cm[q] = fmaxf(cm[q], __shfl_xor_sync(0xffffffffu, cm[q], 16));
  }
  if (lane < 8)
    *reinterpret_cast<float2*>(colmax + w * kFfmaTile + 2 * lane) =
        make_float2(cm[0], cm[1]);
}

// The exact power-of-two factor of column j (common.cuh:rescale_tile)
// from the W warps' maxima; e - 127 is added to *s.
__device__ __forceinline__ float big_column_factor(const float* colmax,
                                                   int W, int j, float* s) {
  float mx = colmax[j];
  for (int w = 1; w < W; ++w) mx = fmaxf(mx, colmax[w * kFfmaTile + j]);
  mx = fmaxf(mx, FLT_MIN);
  const int e = (__float_as_int(mx) >> 23) & 0xFF;
  *s += static_cast<float>(e - 127);
  return __int_as_float((254 - e) << 23);
}

// The whole block copies one tip's rows for its tile: dst[x * 16 + l] =
// row[x * ldt + min(p0 + l, P - 1)] for x < NSp (the ragged edge repeats
// the last column, which is never stored).
__device__ __forceinline__ void big_copy_tip(float* dst,
                                             const float* __restrict__ row,
                                             int NSp, int p0, int P,
                                             size_t ldt, int tid, int nthr) {
  for (int k = tid; k < NSp * kFfmaTile; k += nthr) {
    const int x = k / kFfmaTile, l = k % kFfmaTile;
    cp_async4(dst + k, row + x * ldt + min(p0 + l, P - 1));
  }
}

}  // namespace phyml
