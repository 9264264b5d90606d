// The big-state bodies past the ladder's top rung (ladder.cuh), with the
// state count a run-time argument and no top: the padded width shared by
// both, and the 3xTF32 walk of K3 and K4 (with K1's entry; big_slots.cu).
// K5 (with K2's entry; big_edotp.cu) runs the FFMA walk of big_ffma.cuh,
// which says why.
//
// Replace, past the top rung, phyml_tpu/ops/pallas_clv.py:_uppass_kernel
// (K3) and pallas_clv_slots.py:_slot_stream_kernel (K4; _slot_kernel, K1,
// runs the same body through its entry).  The Pallas kernels take any
// state count padded to `spad`; the ladder's designs keep whole ns x ns
// P-matrices in shared memory and stop near 90 states.
//
// What bounds them on the H100: every product is an ns x ns matrix times
// an ns x (patterns) operand, 2 ns^2 FLOP per pattern, child, class (and
// parameter set).  At 64 taxa x 3636 patterns of amino-acid covarion
// (80 states, C = 4) K3 at B = 13 needs 0.31 TFLOP: 4.6 ms at the FP32
// peak (67 TFLOP/s); the three TF32 passes below are 0.94 TFLOP, 1.9 ms
// at the data sheet's 495 TFLOP/s and 3.0 ms at the 317 TFLOP/s that
// mma.sync reaches on an H100 (tools/mma_rate.py).  The bytes (the
// P-matrices once, the tips) take 0.05 ms.  What limits the walk as
// measured (PERF.md) is neither: a warp is slow on its own whatever the
// ring or the copies, so the time follows the warps an SM holds, which
// the slots' shared memory caps at 8 at 80 states and 6 at 160.
//
// The design (a first design streamed 16 x 16 pieces to every warp
// and ran FFMA on 4 x 2 register tiles, spread the output states over
// the warps and met at two to four block barriers a step):
//
// * Tensor cores at FP32's precision: every product runs as
//   mma.sync.m16n8k8 TF32 in three passes ("3xTF32"): each float operand
//   x splits into hi and lo = x - hi, each rounded to TF32 (10 mantissa
//   bits, tf32_split), and each product accumulates A_lo B_hi, A_hi B_lo
//   and A_hi B_hi in three float32 accumulators; the dropped A_lo B_lo is
//   ~2^-22 of the product.  This is the card's counterpart of the
//   multi-pass `precision=HIGHEST` products of
//   phyml_tpu/ops/pallas_clv.py:101-104; one pass of TF32 alone would keep
//   ~3 digits (tests/test_torch_tf32split.py holds the bound on the CPU).
//   No bf16, no fast math.
// * Warps over patterns: a block holds a tile of T patterns, T /
//   kBigWarpCols warps on its columns and one warp that stages the ring;
//   a warp owns kBigWarpCols pattern columns and every output state of
//   them.  The mma's M side is 16 output states (an m-tile), N the warp's
//   columns, K 8 contraction states.  The rescale's column maximum is the
//   warp's own (shuffles, __syncwarp): no block barrier and no shared
//   column maxima.  K3/K4 give each class its own block, the C blocks of
//   a tile one cluster (the class terms meet in distributed shared
//   memory): C times the blocks, each a C-th of the steps.
// * One ring a block: the P-matrices are staged once a block, in pieces
//   of one m-tile by kBigChunk contraction states, by cp.async from the
//   staging warp into kBigStages stages.  An mbarrier a stage says the
//   piece has landed (cp.async.mbarrier.arrive of the staging warp's
//   lanes) and another that every reading warp is done with it (one
//   arrive a warp); the ring runs across steps and classes, so there is
//   no block barrier a step.
// * Operands in shared memory are pattern-major, [T][NSp + kBigPadN] (a
//   tile): a warp's B fragment is 8 pattern rows by 4 adjacent states,
//   loaded by ldmatrix, and row strides that are 4 mod 8 floats make
//   every fragment load free of bank conflicts; a piece's rows are
//   kBigChunk + kBigPadN floats.
// * Tiles of 32 patterns wherever a block then still leaves two blocks
//   an SM (kBigTwoBlocks), else 16 (big_pass_tile; the rule reads the
//   shape only, never a timing): a staged byte feeds 32 patterns.
//
// Padded states (NSp is ns rounded up to kBigPanel) have zero rows in
// every matrix and a zero in pi, so their values are zero and never win
// a column's maximum.
#pragma once

#include <cstdint>

#include "big_launch.cuh"
#include "common.cuh"

namespace phyml {

constexpr int kBigPanel = 16;      // states of an m-tile; NSp % 16 == 0
constexpr int kBigWarpCols = 8;    // pattern columns of a warp (n-tiles of 8)
constexpr int kBigChunk = 16;      // contraction states of a staged piece
constexpr int kBigStages = 6;      // stages of the ring
constexpr int kBigTileWide = 32;   // patterns of a block's tile, or ...
constexpr int kBigTileNarrow = 16; // ... where the wide tile leaves one block an SM
constexpr int kBigPadN = 4;        // row padding of tiles and pieces
// classes at most that K3/K4 spread over a cluster of one-class blocks
// (the portable cluster size); more classes walk one block in turn
constexpr int kBigClusterMax = 8;
// bytes of shared memory a block may take and leave two blocks an SM
// (233,472 an SM, 1,024 of them reserved a block)
constexpr size_t kBigTwoBlocks = 115712;

constexpr int kBigNT = kBigWarpCols / 8;  // n-tiles of a warp
constexpr int kBigMaxWarps = kBigTileWide / kBigWarpCols;
constexpr int kBigRowN = kBigChunk + kBigPadN;    // a piece's row
constexpr int kBigPieceN = kBigPanel * kBigRowN;  // floats of a piece
// floats of the two mbarrier arrays (full, empty) in front of the ring
constexpr int kBigBarFloats = 2 * kBigStages * 2;
static_assert(kBigWarpCols % 8 == 0 && 32 % kBigWarpCols == 0,
              "a warp's columns are whole n-tiles, a divisor of 32");
static_assert(kBigChunk == 16 && kBigTileWide % kBigWarpCols == 0 &&
                  kBigTileNarrow % kBigWarpCols == 0,
              "NSp (a multiple of 16) is whole chunks; tiles whole warps");

// the top rung of the ladder; the big bodies take every state count
// past it
constexpr int ladder_top() {
  int top = 0;
#define PHYML_TOP(NS, ...) top = NS > top ? NS : top;
  PHYML_LADDER(PHYML_TOP)
#undef PHYML_TOP
  return top;
}
constexpr int kBigMinNS = ladder_top() + 1;

// True for a padded state count the big bodies take.
inline bool big_width(int NSp) {
  return NSp >= kBigMinNS && NSp % kBigPanel == 0;
}

// ---- tensor-core products at FP32's precision -------------------------

// x = hi + lo + O(2^-22 |x|), hi and lo TF32 values (the low 13 bits
// zero, so the tensor cores take them exactly, whatever they do with
// other bits): each rounded to 10 mantissa bits by adding half a TF32
// ulp to its bits (ties away from zero); x - hi is exact in float32.
__device__ __forceinline__ void tf32_split(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(__uint_as_float(x) - __uint_as_float(hi)) +
        0x1000u) &
       0xffffe000u;
}

// Four 8 x 4 blocks of 32-bit words from shared memory, block i's rows
// at the addresses of lanes 8 i .. 8 i + 7 (16-byte aligned): d[i] of
// lane l is word l % 4 of row l / 4 of block i, the A and B fragment
// layouts of mma.m16n8k8 for 32-bit operands.
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(smem_u32(p))
      : "memory");
}

// d += A B: A 16 x 8 (row), B 8 x 8 (col), d 16 x 8, TF32 in, FP32 sums
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- mbarriers -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// arrive once this thread's cp.async copies so far have landed (the
// count of the barrier's phase includes this arrival)
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- the ring --------------------------------------------------------

// What one walk stages: nj matrices (row-major NSp x NSp in device
// memory).  A walk with nj = 0 stages nothing.
struct BigWalk {
  const float* m[2];
  int nj;
};

// The block's ring.  Items are a walk's pieces, m-tile by m-tile and
// chunk by chunk within one, over every walk of desc(0 .. n_walks - 1)
// in order.  The block's last warp stages them (run), kBigStages ahead
// of the slowest of the other W warps, which read every item in the
// same order (acquire, release); each warp keeps its own copy of this
// state.
template <typename Desc>
struct BigRing {
  float* stage;     // [kBigStages][stage_floats]
  uint64_t* full;   // [kBigStages]: the staging warp's copies have landed
  uint64_t* empty;  // [kBigStages]: every reading warp is done with it
  int stage_floats, NSp, n_kc, n_walks;
  Desc desc;
  int it = 0;    // items this warp has read
  int pw = 0;    // the walk of the next item to stage
  BigWalk cur;   // walk pw

  __device__ __forceinline__ void seek(int w) {
    for (pw = w; pw < n_walks; ++pw) {
      cur = desc(pw);
      if (cur.nj > 0) break;
    }
  }

  // the staging warp: every item, each once its stage's last item has
  // been read by every reading warp.  A lane copies the same 16-byte
  // pieces of every item (kBigChunk / 8 of each matrix): its offsets are
  // set once, and an item's are two multiply-adds.
  __device__ __forceinline__ void run() {
    constexpr int kPer = kBigChunk / 4;  // 16-byte pieces of a plain row
    constexpr int kN = kBigChunk / 8;    // a lane's pieces of a matrix
    const int lane = threadIdx.x & 31;
    const int rn = lane / kPer, cn = lane % kPer;
    const size_t srcN = static_cast<size_t>(rn) * NSp + 4 * cn;
    const int dstN = rn * kBigRowN + 4 * cn;
    const size_t stepN = static_cast<size_t>(32 / kPer) * NSp;
    int s = 0, round = 0, mt = 0, kc = 0;  // stage, its round, the item
    for (seek(0); pw < n_walks;) {
      if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
      float* st = stage + s * stage_floats;
      const size_t m0 = mt * kBigPanel, k0 = kc * kBigChunk;
      int off = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j >= cur.nj) break;
        // rows m0 .. m0 + 16 of M_j, its columns k0 .. k0 + kBigChunk
        const float* src = cur.m[j] + m0 * NSp + k0 + srcN;
#pragma unroll
        for (int i = 0; i < kN; ++i)
          cp_async16(st + off + dstN + i * (32 / kPer) * kBigRowN,
                     src + i * stepN);
        off += kBigPieceN;
      }
      mbar_arrive_copies(full + s);
      if (++s == kBigStages) s = 0, ++round;
      if (++kc == n_kc) {
        kc = 0;
        if (++mt == NSp / kBigPanel) {
          mt = 0;
          seek(pw + 1);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // a reading warp: the stage of item `it`, once its copies have landed
  __device__ __forceinline__ const float* acquire() {
    const int s = it % kBigStages;
    mbar_wait(full + s, (it / kBigStages) & 1);
    return stage + s * stage_floats;
  }

  // my warp is done with item `it`
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + it % kBigStages);
    ++it;
  }
};

// The mbarriers of a ring of W reading warps: full[s] waits for the
// staging warp's 32 lanes, empty[s] for the W warps.  One thread.
__device__ __forceinline__ void big_ring_init(uint64_t* bars, int W) {
  for (int s = 0; s < kBigStages; ++s) {
    mbar_init(bars + s, 32);
    mbar_init(bars + kBigStages + s, W);
  }
}

// ---- the walk --------------------------------------------------------
// Fragment layout (PTX mma.m16n8k8, tf32): lane = 4 g + t.  A 16 x 8:
// (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B 8 x 8: (t, g),
// (t + 4, g); D 16 x 8: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
// (rows output states, columns the warp's patterns).

// The warp's share of the ring's next walk, NJ products: for every
// m-tile mt of NSp, acc_j = M_j x_j over all NSp contraction states for
// the warp's kBigWarpCols columns, then epi(mt, acc), acc[j][n] the D
// fragment of n-tile n.  x_j is the warp's first column of a
// pattern-major tile (rows LDk floats apart); the M_j come from the ring,
// one item per m-tile and chunk.
template <int NJ, typename Ring, typename Epi>
__device__ __forceinline__ void big_walk(Ring& ring,
                                         const float* const (&x)[NJ],
                                         int LDk, Epi&& epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int NSp = ring.NSp, n_mt = NSp / kBigPanel, n_kc = ring.n_kc;
  for (int mt = 0; mt < n_mt; ++mt) {
    // A_hi B_hi, A_lo B_hi and A_hi B_lo in three accumulators: three
    // independent chains of mma a product
    float hi[NJ][kBigNT][4], c1[NJ][kBigNT][4], c2[NJ][kBigNT][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < kBigNT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hi[j][n][q] = c1[j][n][q] = c2[j][n][q] = 0.0f;
    for (int kc = 0; kc < n_kc; ++kc) {
      const int k0 = kc * kBigChunk;
      const float* st = ring.acquire();
      const float* a[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) a[j] = st + j * kBigPieceN;
      // B of the chunk's two k-steps: lane l's row is column l % 8 of
      // n-tile n, blocks at k0, k0 + 4, k0 + 8, k0 + 12
      uint32_t bx[NJ][kBigNT][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int n = 0; n < kBigNT; ++n)
          ldsm_x4(bx[j][n],
                  x[j] + (8 * n + (lane & 7)) * LDk + k0 + 4 * (lane >> 3));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = 8 * h;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          // blocks: rows 0-7 and 8-15 at k ks, then at ks + 4
          uint32_t v[4];
          const int b = lane >> 3;
          ldsm_x4(v, a[j] + ((b & 1) * 8 + (lane & 7)) * kBigRowN + ks +
                         4 * (b >> 1));
          uint32_t ah[4], al[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) tf32_split(v[q], ah[q], al[q]);
#pragma unroll
          for (int n = 0; n < kBigNT; ++n) {
            uint32_t bh0, bl0, bh1, bl1;
            tf32_split(bx[j][n][2 * h], bh0, bl0);
            tf32_split(bx[j][n][2 * h + 1], bh1, bl1);
            mma_tf32(c1[j][n], al, bh0, bh1);
            mma_tf32(c2[j][n], ah, bl0, bl1);
            mma_tf32(hi[j][n], ah, bh0, bh1);
          }
        }
      }
      ring.release();
    }
    float acc[NJ][kBigNT][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int n = 0; n < kBigNT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[j][n][q] = hi[j][n][q] + (c1[j][n][q] + c2[j][n][q]);
    epi(mt, acc);
  }
}

// ---- the warp's columns ----------------------------------------------

// A D-shaped fragment y of m-tile m0 into the warp's columns of a
// pattern-major tile (xw: its first column, rows LDk apart), and its
// column maxima into cm[n][q] (column 8 n + 2 t + q).
__device__ __forceinline__ void big_store_frag(float* xw, int LDk, int m0,
                                               const float (&y)[kBigNT][4],
                                               float (&cm)[kBigNT][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < kBigNT; ++n) {
    float* d = xw + (8 * n + 2 * t) * LDk + m0 + g;
    d[0] = y[n][0], d[LDk] = y[n][1];
    d[8] = y[n][2], d[LDk + 8] = y[n][3];
    cm[n][0] = fmaxf(cm[n][0], fmaxf(y[n][0], y[n][2]));
    cm[n][1] = fmaxf(cm[n][1], fmaxf(y[n][1], y[n][3]));
  }
}

// The maxima cm over the 8 lanes g of each column, then the maximum of
// column c (< kBigWarpCols) for the calling lane.
__device__ __forceinline__ float big_colmax(float (&cm)[kBigNT][2], int c) {
#pragma unroll
  for (int n = 0; n < kBigNT; ++n)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        cm[n][q] = fmaxf(cm[n][q], __shfl_xor_sync(0xffffffffu, cm[n][q], o));
  float r = 0.0f;
#pragma unroll
  for (int n = 0; n < kBigNT; ++n)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float v = __shfl_sync(0xffffffffu, cm[n][q], (c & 7) >> 1);
      if (n == (c >> 3) && q == (c & 1)) r = v;
    }
  return r;
}

// The exact power-of-two factor of a column whose maximum is mx
// (common.cuh:rescale_tile); e - 127 is added to *s.
__device__ __forceinline__ float big_factor(float mx, float* s) {
  mx = fmaxf(mx, FLT_MIN);
  const int e = (__float_as_int(mx) >> 23) & 0xFF;
  *s += static_cast<float>(e - 127);
  return __int_as_float((254 - e) << 23);
}

// The warp copies rows 0 .. NSp - 1 of a row-major [.][ld] array, at
// columns col0 + c (c < kBigWarpCols, clamped to cmax: the ragged edge
// repeats a column, which is never stored), into its columns of a
// pattern-major tile (xw: its first column), by cp.async (4 bytes, one
// group; the reading warps issue no other cp.async).
__device__ __forceinline__ void big_load_cols(float* xw, int LDk,
                                              const float* src, size_t ld,
                                              int NSp, int col0, int cmax) {
  const int lane = threadIdx.x & 31, c = lane % kBigWarpCols;
  const float* s = src + min(col0 + c, cmax);
  float* d = xw + c * LDk;
  for (int r = lane / kBigWarpCols; r < NSp; r += 32 / kBigWarpCols)
    cp_async4(d + r, s + r * ld);
  cp_async_commit();
}

// Ask L1 for the lines of rows 0 .. NSp - 1 of a [.][ld] array at column
// col (the warp's next operand, read some steps later).
__device__ __forceinline__ void big_prefetch_rows(const float* src,
                                                  size_t ld, int NSp,
                                                  int col) {
  for (int r = threadIdx.x & 31; r < NSp; r += 32)
    asm volatile("prefetch.global.L1 [%0];\n" ::"l"(src + r * ld + col));
}

}  // namespace phyml
