// K7: the engine's scan passes, one launch a pass.
//
// Replaces no TPU kernel: the JAX package runs these passes in jnp
// (phyml_tpu/ops/likelihood.py, _up_pass / _down_pass).  The port ran
// them as Python loops over the internal nodes, which stay as K7's plain
// version (ops/likelihood.py: LikelihoodEngine._up_pass / _down_pass
// on the CPU, in float64 or masked), about 11 PyTorch operations an up
// step and 19 a down step, each a few MB: the card finished each before
// the host had issued the next.
//
// What it computes, the loops' contract (divide-by-max rescaling,
// natural-log scales).  Layout: pup, clv, out [n_nodes, C, ns, P] and
// sc, sc_out [n_nodes, C, P], a leading axis of R trees when stacked;
// each stored with rows Pw apart (P rounded up to 32, so that a tile's
// rows are whole sectors), the wrapper's views of the first P.
//   up (phyml_scan_up), node by node in postorder:
//     tip u:            clv[u] = tip[u], pup[u] = P_u clv[u], sc[u] = 0
//     internal u = n + i, children (c0, c1) = child[i]:
//       x = pup[c0] * pup[c1],  m = max(max over states of x, FLT_MIN)
//       clv[u] = x / m,  sc[u] = (sc[c0] + sc[c1]) + ln m,
//       pup[u] = P_u clv[u]
//   down (phyml_scan_down), reverse postorder:
//     root's children (r0, r1): out[r0] = pi pup[r1], sc_out[r0] = sc[r1]
//       and the same with r0 and r1 swapped (no rescale)
//     internal u = n + i below the root, children (c0, c1):
//       g = P_u^T out[u];  o0 = g * pup[c1],  m0 = max(max o0, FLT_MIN)
//       out[c0] = o0 / m0,  sc_out[c0] = (sc_out[u] + sc[c1]) + ln m0
//       (and the same for c1 against pup[c0])
//     the root's row of out and sc_out: zeros.
// The product x and the division are the loop's to the bit; a matrix
// product sums its ns terms in ascending order with fused multiply-adds
// (float32 throughout, no TF32, logf accurate), so pup and out differ
// from the loop's (cuBLAS's order of sums) by rounding at most.
//
// Bound (H100: 3.35 TB/s, 67 TFLOP/s FP32).  Up: read every node's pup
// once as a child and the tips, write pup and clv; down: read pup of
// every non-root node and out of every internal node, write out.  At 120
// taxa x 9,771 patterns of amino acids (C = 4) a [239, 4, 20, P] tensor
// is 0.75 GB: about 2.4 GB up, 2.0 GB down, 0.72 and 0.58 ms; the
// 80-state covarion (C = 1) does 31 GFLOP up (0.47 ms), under its bytes.
// At 4 states the 239 dependent node steps, not the bytes, set the time.
//
// Design (patterns are independent, so a block owns one tile of
// patterns of one class of one tree and walks the whole tree for it:
// grid (tiles, C, R), no block ever waits on another):
// - Up to 32 states, one warp a block at the rung of the ladder
//   (ladder.cuh; ns padded to it): a lane holds R states x Q patterns
//   of a column split over G = NS / R adjacent lanes, whose maxima meet
//   by shuffles; the products are the ladder's register tiles
//   (tile_matmul, tile_matmul_t; at 20 states R = 5, Q = 4, a tile of
//   32 patterns).  Only __syncwarp: a step has no block barrier.
// - Past 32 states, blocks of 2 NS threads (the wide body, NS = ns
//   rounded up to 4; fewer past 256 states, below): a thread holds 4
//   states x 4 patterns of a tile of 32; a column's maximum meets in
//   shared memory (a barrier).  The up
//   product reads its matrix transposed from shared memory, copied by a
//   conflict-free copy (rows ld apart, ld / 4 odd) as soon as the step
//   before is done with the last one: one matrix, not a ring of two,
//   so that three blocks fit an SM at 80 states.  The down product
//   reads its matrix where it lies, 8 loads in flight (staged, its
//   block left fewer blocks an SM and ran slower).  Past 180 states the
//   staged matrix does not fit: the up product then reads its matrix's
//   rows where they lie, 16 bytes of each of a thread's 4 rows at a
//   time (the sums in the same order); past 256 states the tile halves
//   (16, 8, 4 patterns) so that a block keeps to 512 threads, up to
//   2,048 states.  Past them the launcher refuses.
// - Each step's operands (the children's pup tiles and scale rows, a
//   down step's out[u]) are copied with cp.async into one stage of a
//   ring, D steps ahead: the walk is a chain of dependent steps, so the
//   copies of the next steps are in flight while one computes (D = 2 up
//   to 32 states, down 1 from 12 states on; 1 in the wide body).  A
//   step's result that one of the next D steps reads (in postorder most
//   nodes closely follow a child; in reverse, a parent) is written
//   straight into that step's stage instead of being read back.  Every
//   result is still stored: the NNI scorer reads every node's pup, clv
//   and out (the one-warp body through its consumed slots, so that each
//   store instruction writes runs of adjacent patterns).
// - The P-matrices lie rows NS apart (the wrapper pads them where ns is
//   not NS); the one-warp body reads them where they lie (a node's
//   matrix of a class, at most 4 KB, is one that every tile's block
//   reads at that step: an L1 or L2 hit after the first).  Sums over k
//   run ascending with fused multiply-adds.
// - Padded states are zero rows of the staged operands, which never
//   raise a column's maximum and add nothing to a product.
// - Each block checks the child table once and traps on a child outside
//   [0, n_otu + i) for row i or on two equal children: the walk relies
//   on the postorder.
#include "common.cuh"

namespace phyml {

// ---- up to 32 states: one warp a block, a rung of the ladder ----------
// A lane holds R states x Q patterns of a column split over G = NS / R
// adjacent lanes (the ladder's register tiles, common.cuh), so a warp's
// tile is T = 32 / G x Q patterns.
__host__ __device__ constexpr int scan_warp_rows(int NS) {
  return NS == 12 ? 3 : NS == 20 ? 5 : NS == 24 ? 6 : 4;
}
__host__ __device__ constexpr int scan_warp_cols(int NS) {
  return NS == 4 ? 1 : NS == 8 ? 2 : 4;
}
__host__ __device__ constexpr int scan_warp_tile(int NS) {
  return 32 / (NS / scan_warp_rows(NS)) * scan_warp_cols(NS);
}
// the steps a pass's copies run ahead: 2 up; down, where a stage holds
// three tiles, 2 up to 8 states and 1 past them (more resident blocks)
__host__ __device__ constexpr int scan_warp_ahead(int NS, bool down) {
  return down && NS > 8 ? 1 : 2;
}
// floats of shared memory: the ring's stages of 2 (up) or 3 (down)
// staged tiles of NS rows and the scale row
__host__ __device__ constexpr int scan_warp_smem_floats(int NS, bool down) {
  return (scan_warp_ahead(NS, down) + 1) * (down ? 3 : 2) * (NS + 1) *
         scan_warp_tile(NS);
}

// ---- past 32 states: blocks of NS / 4 x T / 4 threads (the wide body) --
// A thread holds 4 states (a state group) x kWideCols patterns of a tile
// of T (kWideTile, or less past 256 states); the copies run one step
// ahead (a ring of 2 stages); at most kWideMaxThreads threads, 128
// registers each.  The tile of 32 halves the blocks and keeps every one
// resident (317 blocks at three an SM on an H100's 132 SMs); tiles of 16
// at 2 patterns a thread took up 2.42 -> 2.11 ms and down 1.68 -> 1.64
// ms at 80 states on an H100.
constexpr int kWideTile = 32, kWideCols = 4, kWideMaxThreads = 512;
// the steps the wide body's copies run ahead (a ring of two stages)
constexpr int kWideAhead = 1;
// The up product reads its matrix transposed from shared memory, rows
// scan_pt_ld(NS) apart: ld / 4 odd, so that the staging copy's 8 rows x
// 4 columns a warp land in 32 banks.
__host__ __device__ constexpr int scan_pt_ld(int NS) {
  return (NS / 4) % 2 ? NS : NS + 4;
}
// Floats of shared memory at a tile of T: up and `staged`, the step's
// matrix transposed (NS rows of scan_pt_ld(NS)); the ring's stages of 2
// (up: the children) or 3 (down: the children, out[u]) staged tiles (NS
// rows and the scale row of T patterns); rows of column maxima of the
// NS / 4 state groups, 1 up and 2 down.
__host__ __device__ constexpr int scan_wide_smem_floats(int NS, int T,
                                                        bool down,
                                                        bool staged) {
  return (staged ? NS * scan_pt_ld(NS) : 0) +
         (kWideAhead + 1) * (down ? 3 : 2) * (NS + 1) * T +
         (down ? 2 : 1) * (NS / 4) * T;
}

// The product with M's transpose, acc[r][j] = sum_k M[k ld + 4 sg + r]
// X[k T + Q cg + j], k ascending: 4 columns of M (one 16-byte word of
// each of its rows, ld apart) times Q columns of an [NS][T] tile.  The
// wide body's down product (M = P, ld = NS) and up product (M = P's
// transpose staged in shared memory).
template <int T, int Q>
__device__ __forceinline__ void scan_product_cols(const float* __restrict__ M,
                                                  int ld,
                                                  const float* __restrict__ X,
                                                  int NS, int sg, int cg,
                                                  float (&acc)[4][Q]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < Q; ++j) acc[r][j] = 0.0f;
  const float* m = M + 4 * sg;
  const float* x = X + Q * cg;
  // 8 loads of M in flight: the down pass reads it from global memory
#pragma unroll 8
  for (int k = 0; k < NS; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(m + k * ld);
    float v[Q];
    load_q<Q>(x + k * T, v);
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      acc[0][j] += p.x * v[j];
      acc[1][j] += p.y * v[j];
      acc[2][j] += p.z * v[j];
      acc[3][j] += p.w * v[j];
    }
  }
}

// The product with M itself, acc[r][j] = sum_k M[(4 sg + r) ld + k]
// X[k T + Q cg + j], k ascending as scan_product_cols sums: 16 bytes of
// each of a thread's 4 rows of M (rows ld apart, ld a multiple of 4)
// times 4 rows of an [NS][T] tile.  The wide body's up product past the
// staged matrix (M = P where it lies, ld = NS).
template <int T, int Q>
__device__ __forceinline__ void scan_product_rows(const float* __restrict__ M,
                                                  int ld,
                                                  const float* __restrict__ X,
                                                  int NS, int sg, int cg,
                                                  float (&acc)[4][Q]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < Q; ++j) acc[r][j] = 0.0f;
  const float* m = M + static_cast<size_t>(4 * sg) * ld;
  const float* x = X + Q * cg;
  for (int k = 0; k < NS; k += 4) {
    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(p[r]) =
          *reinterpret_cast<const float4*>(m + r * ld + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[Q];
      load_q<Q>(x + (k + kk) * T, v);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < Q; ++j) acc[r][j] += p[r][kk] * v[j];
    }
  }
}

// The block's copies, each thread's share of the elements tid, tid +
// nthr, ... (consecutive threads, consecutive patterns).
//
// `rows` rows of a tip's tile: dst[r T + l] = src[r P + min(p0 + l, P -
// 1)] (past P the last pattern's column, so that the padded columns of
// K7's tensors hold copies of the last pattern's values).
template <int T>
__device__ __forceinline__ void scan_fetch_rows(float* dst,
                                                const float* __restrict__ src,
                                                int rows, int p0, int P,
                                                int tid, int nthr) {
  for (int e = tid; e < rows * T; e += nthr) {
    const int r = e / T, l = e % T;
    cp_async4(dst + e,
              src + static_cast<size_t>(r) * P + min(p0 + l, P - 1));
  }
}

// The transpose of one class's NS x NS matrix (rows NS apart at src)
// into Pt (rows ld apart): Pt[y ld + x] = P[x][y], each whole warp of
// the block 8 rows y x 4 columns x an instruction (32 B of 4 rows of
// P; 32 banks of Pt).  `async`: cp.async (the ring), else loads and
// stores now.
__device__ __forceinline__ void scan_fetch_transpose(
    float* Pt, const float* __restrict__ src, int NS, int ld, bool async,
    int tid, int nthr) {
  const int warps = nthr / 32, w = tid / 32, lane = tid % 32;
  if (w >= warps) return;
  const int xo = lane / 8, yo = lane % 8;
  for (int y = 8 * w + yo; y - yo < NS; y += 8 * warps) {
    if (y >= NS) continue;
    for (int x = xo; x < NS; x += 4) {
      if (async)
        cp_async4(Pt + y * ld + x, src + x * NS + y);
      else
        Pt[y * ld + x] = src[x * NS + y];
    }
  }
}

// `rows` rows of T patterns of one of K7's own tensors (rows Pw apart,
// Pw a multiple of 32, src at the tile's first pattern): dst[r T + l] =
// src[r Pw + l], in 16-byte copies.
template <int T>
__device__ __forceinline__ void scan_fetch_tile(float* dst,
                                                const float* __restrict__ src,
                                                int rows, int Pw, int tid,
                                                int nthr) {
  constexpr int kPieces = T / 4;  // of a row
  for (int e = tid; e < rows * kPieces; e += nthr) {
    const int r = e / kPieces, q = e % kPieces;
    cp_async16(dst + r * T + 4 * q, src + static_cast<size_t>(r) * Pw + 4 * q);
  }
}

// A one-warp block stores `rows` rows of a staged [NS][T] tile into a
// node's rows of one of K7's own tensors (dst at the tile's first
// pattern), 16 bytes a lane: a store instruction writes whole sectors.
template <int T>
__device__ __forceinline__ void scan_store_rows(float* __restrict__ dst,
                                                const float* tile, int rows,
                                                int Pw) {
  constexpr int kPieces = T / 4;
  for (int e = threadIdx.x; e < rows * kPieces; e += 32) {
    const int r = e / kPieces, q = e % kPieces;
    *reinterpret_cast<float4*>(dst + static_cast<size_t>(r) * Pw + 4 * q) =
        *reinterpret_cast<const float4*>(tile + r * T + 4 * q);
  }
}

// The root's rows of out and sc_out (my class, my tile) are zeros.
template <int T>
__device__ __forceinline__ void scan_zero_root(float* __restrict__ out,
                                               float* __restrict__ sc_out,
                                               size_t root_row, size_t plane,
                                               int ns, int p0, int Pw, int tid,
                                               int nthr) {
  for (int e = tid; e < (ns + 1) * T; e += nthr) {
    const int r = e / T, l = e % T;
    if (r < ns)
      out[root_row * plane + static_cast<size_t>(r) * Pw + p0 + l] = 0.0f;
    else
      sc_out[root_row * Pw + p0 + l] = 0.0f;
  }
}

// True where the down step of row i (node u) finds out[u] handed over:
// its parent is the node of one of the D steps before it (rows i + 1 ..
// i + D), which writes it into this step's stage.
__device__ __forceinline__ bool scan_handed(const int* __restrict__ child,
                                            int i, int u, int n_int, int D) {
  bool handed = false;
  for (int j = 1; j <= D; ++j)
    if (i + j < n_int)
      handed |= child[2 * (i + j)] == u || child[2 * (i + j) + 1] == u;
  return handed;
}

// Trap on a child table that is not a postorder of n_otu tips: row i's
// children in [0, n_otu + i) and distinct.
__device__ __forceinline__ void scan_check_children(
    const int* __restrict__ child, int n_otu, int n_int, int tid, int nthr) {
  bool bad = false;
  for (int i = tid; i < n_int; i += nthr) {
    const int a = child[2 * i], b = child[2 * i + 1];
    const unsigned lim = static_cast<unsigned>(n_otu + i);
    bad |= static_cast<unsigned>(a) >= lim ||
           static_cast<unsigned>(b) >= lim || a == b;
  }
  if (__syncthreads_or(bad)) __trap();
}

// A thread's Q column maxima over its 4 states of v.
template <int Q>
__device__ __forceinline__ void scan_local_max(const float (&v)[4][Q],
                                               float (&lm)[Q]) {
#pragma unroll
  for (int j = 0; j < Q; ++j)
    lm[j] = fmaxf(fmaxf(v[0][j], v[1][j]), fmaxf(v[2][j], v[3][j]));
}

// The column maxima over the SG state groups, from the rows `red` [SG][T]
// each thread wrote its lm to before a barrier (four running maxima, so
// that the reads are not one chain); floored at FLT_MIN.
template <int T, int Q>
__device__ __forceinline__ void scan_column_max(float (&lm)[Q],
                                                const float* red, int SG,
                                                int cg) {
  if (SG > 1) {
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      const float* col = red + Q * cg + j;
      float m[4] = {col[0], col[0], col[0], col[0]};
      int s = 1;
      for (; s + 3 < SG; s += 4)
#pragma unroll
        for (int k = 0; k < 4; ++k) m[k] = fmaxf(m[k], col[(s + k) * T]);
      for (; s < SG; ++s) m[0] = fmaxf(m[0], col[s * T]);
      lm[j] = fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
    }
  }
#pragma unroll
  for (int j = 0; j < Q; ++j) lm[j] = fmaxf(lm[j], FLT_MIN);
}

// A thread's 4 rows x Q columns into a node's rows of one of K7's own
// tensors (rows Pw apart; the rows below ns).
template <int Q>
__device__ __forceinline__ void scan_store(float* __restrict__ dst,
                                           const float (&v)[4][Q], int row0,
                                           int col0, int ns, int Pw) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (row0 + r < ns)
      store_q<Q>(dst + static_cast<size_t>(row0 + r) * Pw + col0, v[r]);
}

// The same 4 x Q values into a staged [NS][T] tile (all NS rows), and
// back.
template <int T, int Q>
__device__ __forceinline__ void scan_put(float* tile, const float (&v)[4][Q],
                                         int sg, int cg) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    store_q<Q>(tile + (4 * sg + r) * T + Q * cg, v[r]);
}

template <int T, int Q>
__device__ __forceinline__ void scan_get(float (&v)[4][Q], const float* tile,
                                         int sg, int cg) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    load_q<Q>(tile + (4 * sg + r) * T + Q * cg, v[r]);
}

// ---- up to 32 states: one warp a block -------------------------------

// A pass at a rung NS of the ladder: lane = column group x G + g holds
// states g R .. g R + R - 1 of Q patterns, the column split over the G
// adjacent lanes whose maxima meet by shuffles (common.cuh:
// column_max); the products are the ladder's register tiles
// (tile_matmul, tile_matmul_t) reading each matrix where it lies.  A
// step's results go through its own stage's slots (the operands it has
// consumed) so that each store instruction writes runs of T adjacent
// patterns.
template <int NS>
__global__ void scan_up_warp(const int* __restrict__ child,
                             const float* __restrict__ tips,
                             const float* __restrict__ pmats,
                             float* __restrict__ pup, float* __restrict__ clv,
                             float* __restrict__ sc, int n_otu, int n_int,
                             int ns, int P, int Pw) {
  constexpr int R = scan_warp_rows(NS), Q = scan_warp_cols(NS), G = NS / R;
  constexpr int T = scan_warp_tile(NS), D = scan_warp_ahead(NS, false);
  constexpr int S = D + 1, SL = (NS + 1) * T;
  const int lane = threadIdx.x;
  const int g = lane % G, lp = lane / G * Q;  // my states g R.., patterns lp..
  const int C = gridDim.y, c = blockIdx.y, p0 = blockIdx.x * T;
  const int n_nodes = n_otu + n_int;
  const size_t plane = static_cast<size_t>(ns) * Pw;  // rows Pw apart
  const size_t tip_plane = static_cast<size_t>(ns) * P;
  {
    const size_t z = blockIdx.z, nodes = static_cast<size_t>(n_nodes) * C;
    child += z * 2 * n_int;
    pmats += z * nodes * NS * NS;
    pup += z * nodes * plane;
    clv += z * nodes * plane;
    sc += z * nodes * Pw;
  }
  extern __shared__ __align__(16) float smem[];  // [S][2][NS + 1][T]
  auto slot = [&](int t, int k) { return smem + (2 * (t % S) + k) * SL; };
  auto node_row = [&](int u) { return static_cast<size_t>(u) * C + c; };
  auto mat_of = [&](int u) { return pmats + node_row(u) * NS * NS; };

  scan_check_children(child, n_otu, n_int, lane, 32);
  for (int e = lane; e < S * 2 * SL; e += 32) smem[e] = 0.0f;
  __syncwarp();

  auto fetch = [&](int t) {
    if (t < n_otu) {
      scan_fetch_rows<T>(slot(t, 0), tips + static_cast<size_t>(t) * tip_plane,
                         ns, p0, P, lane, 32);
    } else if (t < n_nodes) {
      const int i = t - n_otu;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int u = child[2 * i + k];
        if (u >= t - D) continue;
        scan_fetch_tile<T>(slot(t, k), pup + node_row(u) * plane + p0, ns, Pw,
                           lane, 32);
        scan_fetch_tile<T>(slot(t, k) + NS * T, sc + node_row(u) * Pw + p0, 1,
                           Pw, lane, 32);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int t = 0; t < D; ++t) fetch(t);
  for (int t = 0; t < n_nodes; ++t) {
    cp_async_wait<D - 1>();
    __syncwarp();
    fetch(t + D);
    float* held = nullptr;
#pragma unroll
    for (int j = 1; j <= D; ++j) {
      const int i = t + j - n_otu;
      if (i >= 0 && i < n_int) {
        if (child[2 * i] == t) held = slot(t + j, 0);
        if (child[2 * i + 1] == t) held = slot(t + j, 1);
      }
    }
    // a tip step's clv is its tip (slot 0) and its pup goes to slot 1;
    // an internal step's clv goes to slot 1 and its pup to slot 0
    float* clv_tile = slot(t, t < n_otu ? 0 : 1);
    float* pup_tile = slot(t, t < n_otu ? 1 : 0);
    if (t < n_otu) {
      if (g == 0 && held)
#pragma unroll
        for (int j = 0; j < Q; ++j) held[NS * T + lp + j] = 0.0f;
    } else {
      const float* x0 = slot(t, 0);
      const float* x1 = slot(t, 1);
      float v[R][Q], m[Q], s[Q];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        float b[Q];
        load_q<Q>(x0 + (g * R + a) * T + lp, v[a]);
        load_q<Q>(x1 + (g * R + a) * T + lp, b);
#pragma unroll
        for (int j = 0; j < Q; ++j) v[a][j] *= b[j];
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        float mj = v[0][j];
#pragma unroll
        for (int a = 1; a < R; ++a) mj = fmaxf(mj, v[a][j]);
        m[j] = fmaxf(column_max<G>(mj), FLT_MIN);
        s[j] = (x0[NS * T + lp + j] + x1[NS * T + lp + j]) + logf(m[j]);
      }
      __syncwarp();  // every lane has read x0 and x1
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int j = 0; j < Q; ++j) v[a][j] = v[a][j] / m[j];
        store_q<Q>(clv_tile + (g * R + a) * T + lp, v[a]);
      }
      if (g == 0) {
        store_q<Q>(sc + node_row(t) * Pw + p0 + lp, s);
        if (held) store_q<Q>(held + NS * T + lp, s);
      }
      __syncwarp();  // this step's clv is whole
    }
    float acc[R][Q];
    tile_matmul<NS, R, Q>(mat_of(t) + g * R * NS, clv_tile + lp, T, acc);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      store_q<Q>(pup_tile + (g * R + a) * T + lp, acc[a]);
      if (held) store_q<Q>(held + (g * R + a) * T + lp, acc[a]);
    }
    if (t < n_otu && g == 0) {
      const float zero[Q] = {};
      store_q<Q>(sc + node_row(t) * Pw + p0 + lp, zero);
    }
    __syncwarp();  // this step's pup is whole
    scan_store_rows<T>(clv + node_row(t) * plane + p0, clv_tile, ns, Pw);
    scan_store_rows<T>(pup + node_row(t) * plane + p0, pup_tile, ns, Pw);
  }
  cp_async_wait<0>();
}

template <int NS>
__global__ void scan_down_warp(const int* __restrict__ child,
                               const float* __restrict__ pmats,
                               const float* __restrict__ pi,
                               const float* __restrict__ pup,
                               const float* __restrict__ sc,
                               float* __restrict__ out,
                               float* __restrict__ sc_out, int n_otu,
                               int n_int, int ns, int P, int Pw) {
  constexpr int R = scan_warp_rows(NS), Q = scan_warp_cols(NS), G = NS / R;
  constexpr int T = scan_warp_tile(NS), D = scan_warp_ahead(NS, true);
  constexpr int S = D + 1, SL = (NS + 1) * T;
  const int lane = threadIdx.x;
  const int g = lane % G, lp = lane / G * Q;
  const int C = gridDim.y, c = blockIdx.y, p0 = blockIdx.x * T;
  const int n_nodes = n_otu + n_int;
  const size_t plane = static_cast<size_t>(ns) * Pw;
  {
    const size_t z = blockIdx.z, nodes = static_cast<size_t>(n_nodes) * C;
    child += z * 2 * n_int;
    pmats += z * nodes * NS * NS;
    pup += z * nodes * plane;
    sc += z * nodes * Pw;
    out += z * nodes * plane;
    sc_out += z * nodes * Pw;
  }
  // [S][pup c0, pup c1, out u][NS + 1][T]
  extern __shared__ __align__(16) float smem[];
  auto slot = [&](int s, int k) { return smem + (3 * (s % S) + k) * SL; };
  auto node_row = [&](int u) { return static_cast<size_t>(u) * C + c; };
  auto mat_of = [&](int u) { return pmats + node_row(u) * NS * NS; };

  scan_check_children(child, n_otu, n_int, lane, 32);
  for (int e = lane; e < S * 3 * SL; e += 32) smem[e] = 0.0f;
  scan_zero_root<T>(out, sc_out, node_row(n_nodes - 1), plane, ns, p0, Pw,
                    lane, 32);
  __syncwarp();

  auto fetch = [&](int s) {
    if (s < n_int) {
      const int i = n_int - 1 - s, u = n_otu + i;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int v = child[2 * i + k];
        scan_fetch_tile<T>(slot(s, k), pup + node_row(v) * plane + p0, ns, Pw,
                           lane, 32);
        scan_fetch_tile<T>(slot(s, k) + NS * T, sc + node_row(v) * Pw + p0, 1,
                           Pw, lane, 32);
      }
      if (s > 0 && !scan_handed(child, i, u, n_int, D)) {
        scan_fetch_tile<T>(slot(s, 2), out + node_row(u) * plane + p0, ns, Pw,
                           lane, 32);
        scan_fetch_tile<T>(slot(s, 2) + NS * T, sc_out + node_row(u) * Pw + p0,
                           1, Pw, lane, 32);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < D; ++s) fetch(s);
  for (int s = 0; s < n_int; ++s) {
    const int i = n_int - 1 - s, u = n_otu + i;
    const int ch[2] = {child[2 * i], child[2 * i + 1]};
    cp_async_wait<D - 1>();
    __syncwarp();
    fetch(s + D);
    float gv[R][Q], gs[Q];
    if (s == 0) {
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int row = g * R + a;
        const float p = row < ns ? pi[c * ns + row] : 0.0f;
#pragma unroll
        for (int j = 0; j < Q; ++j) gv[a][j] = p;
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) gs[j] = 0.0f;
    } else {
      tile_matmul_t<NS, R, Q>(mat_of(u) + g * R, slot(s, 2) + lp, T, gv);
      load_q<Q>(slot(s, 2) + NS * T + lp, gs);
    }
    // o[k]: child k's outside partial, g times the other child's pup;
    // so[k] its scale
    float o[2][R][Q], so[2][Q];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* x = slot(s, 1 - k);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        float b[Q];
        load_q<Q>(x + (g * R + a) * T + lp, b);
#pragma unroll
        for (int j = 0; j < Q; ++j) o[k][a][j] = gv[a][j] * b[j];
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const float xs = x[NS * T + lp + j];
        if (s == 0) {
          so[k][j] = xs;
          continue;
        }
        float mj = o[k][0][j];
#pragma unroll
        for (int a = 1; a < R; ++a) mj = fmaxf(mj, o[k][a][j]);
        mj = fmaxf(column_max<G>(mj), FLT_MIN);
#pragma unroll
        for (int a = 0; a < R; ++a) o[k][a][j] = o[k][a][j] / mj;
        so[k][j] = (gs[j] + xs) + logf(mj);
      }
    }
    __syncwarp();  // every lane has read this stage's pup slots
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float* held = nullptr;
#pragma unroll
      for (int j = 1; j <= D; ++j)
        if (s + j < n_int && ch[k] == u - j) held = slot(s + j, 2);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        store_q<Q>(slot(s, k) + (g * R + a) * T + lp, o[k][a]);
        if (held) store_q<Q>(held + (g * R + a) * T + lp, o[k][a]);
      }
      if (g == 0) {
        store_q<Q>(sc_out + node_row(ch[k]) * Pw + p0 + lp, so[k]);
        if (held) store_q<Q>(held + NS * T + lp, so[k]);
      }
    }
    __syncwarp();  // the children's out tiles are whole
#pragma unroll
    for (int k = 0; k < 2; ++k)
      scan_store_rows<T>(out + node_row(ch[k]) * plane + p0, slot(s, k), ns,
                         Pw);
  }
  cp_async_wait<0>();
}

// ---- past 32 states: the wide body ------------------------------------

// kStaged: the step's matrix staged transposed in shared memory (up to
// 180 states), else its rows read where they lie (scan_product_rows).
template <int T, bool kStaged>
__global__ void __maxnreg__(128)
    scan_up_wide(const int* __restrict__ child,
                 const float* __restrict__ tips,
                 const float* __restrict__ pmats, float* __restrict__ pup,
                 float* __restrict__ clv, float* __restrict__ sc, int n_otu,
                 int n_int, int ns, int P, int Pw) {
  constexpr int Q = kWideCols, D = kWideAhead;
  constexpr int CG = T / Q;  // column groups: the threads of a state group
  constexpr int S = D + 1;   // the ring's stages
  const int NS = (ns + 3) & ~3, SG = NS / 4;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid % CG, sg = tid / CG;
  const int C = gridDim.y, c = blockIdx.y, p0 = blockIdx.x * T;
  const int col0 = p0 + Q * cg;
  const int n_nodes = n_otu + n_int;
  // a class of a node: rows Pw apart in K7's tensors, P in the tips
  const size_t plane = static_cast<size_t>(ns) * Pw;
  const size_t tip_plane = static_cast<size_t>(ns) * P;
  {
    // my tree (grid.z) of a stack: its operands at 64-bit offsets
    const size_t z = blockIdx.z, nodes = static_cast<size_t>(n_nodes) * C;
    child += z * 2 * n_int;
    pmats += z * nodes * NS * NS;
    pup += z * nodes * plane;
    clv += z * nodes * plane;
    sc += z * nodes * Pw;
  }
  const int SL = (NS + 1) * T;  // a staged tile
  const int ld = scan_pt_ld(NS);  // the transposed matrix's row stride
  extern __shared__ __align__(16) float smem[];
  float* pt = smem;                  // [NS][ld] this step's matrix, P^T
  float* slots = pt + (kStaged ? NS * ld : 0);  // [S][2 children][NS + 1][T]
  float* red = slots + 2 * S * SL;   // [SG][T] column maxima
  auto slot = [&](int t, int k) { return slots + (2 * (t % S) + k) * SL; };
  auto node_row = [&](int u) {  // (node, my class) row of [n_nodes, C, ...]
    return static_cast<size_t>(u) * C + c;
  };
  // node u's matrix for my class, rows NS apart, where it lies
  auto mat_of = [&](int u) { return pmats + node_row(u) * NS * NS; };

  scan_check_children(child, n_otu, n_int, tid, nthr);
  // padded states stay zero rows: the copies write rows below ns only
  for (int e = tid; e < scan_wide_smem_floats(NS, T, false, kStaged);
       e += nthr)
    smem[e] = 0.0f;
  __syncthreads();

  // step t computes node t: tips first, then the internal nodes in
  // postorder.  fetch(t) is issued at step t - D: a child made at step
  // t - D or later is written into step t's stage by the step that
  // makes it (held), not copied.
  auto fetch = [&](int t) {
    if (t < n_nodes) {
      if (t < n_otu) {
        scan_fetch_rows<T>(slot(t, 0),
                           tips + static_cast<size_t>(t) * tip_plane, ns, p0,
                           P, tid, nthr);
      } else {
        const int i = t - n_otu;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int u = child[2 * i + k];
          if (u >= t - D) continue;
          scan_fetch_tile<T>(slot(t, k), pup + node_row(u) * plane + p0, ns,
                             Pw, tid, nthr);
          scan_fetch_tile<T>(slot(t, k) + NS * T, sc + node_row(u) * Pw + p0,
                             1, Pw, tid, nthr);
        }
      }
    }
    cp_async_commit();  // possibly empty: one group a step
  };

  // step t's matrix is copied once step t - 1's product is done, the
  // first with step 0's operands
  if constexpr (kStaged)
    scan_fetch_transpose(pt, mat_of(0), NS, ld, true, tid, nthr);
#pragma unroll
  for (int t = 0; t < D; ++t) fetch(t);
  for (int t = 0; t < n_nodes; ++t) {
    cp_async_wait<0>();  // my copies of step t and its matrix have landed
    __syncthreads();     // ... and everyone's; step t - 1's stage is free
    fetch(t + D);
    // the slot of the step among the next D that takes node t, if any
    float* held = nullptr;
#pragma unroll
    for (int j = 1; j <= D; ++j) {
      const int i = t + j - n_otu;
      if (i >= 0 && i < n_int) {
        if (child[2 * i] == t) held = slot(t + j, 0);
        if (child[2 * i + 1] == t) held = slot(t + j, 1);
      }
    }
    float v[4][Q];
    const float* X;  // this step's clv: the tip, or x / m
    if (t < n_otu) {
      X = slot(t, 0);
      scan_get<T, Q>(v, X, sg, cg);
      scan_store<Q>(clv + node_row(t) * plane, v, 4 * sg, col0, ns, Pw);
      if (sg == 0) {
        const float zero[Q] = {};
        store_q<Q>(sc + node_row(t) * Pw + col0, zero);
        if (held) store_q<Q>(held + NS * T + Q * cg, zero);
      }
    } else {
      const float* x0 = slot(t, 0);
      const float* x1 = slot(t, 1);
      float b[4][Q], lm[Q];
      scan_get<T, Q>(v, x0, sg, cg);
      scan_get<T, Q>(b, x1, sg, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < Q; ++j) v[r][j] *= b[r][j];
      scan_local_max<Q>(v, lm);
      if (SG > 1) {
        store_q<Q>(red + sg * T + Q * cg, lm);
        __syncthreads();
      }
      scan_column_max<T, Q>(lm, red, SG, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < Q; ++j) v[r][j] = v[r][j] / lm[j];
      // this step's clv, the product's operand, in x1's rows: every
      // thread has read them before the barrier above (SG > 1 past 32
      // states); x1's scale row stays
      scan_put<T, Q>(slot(t, 1), v, sg, cg);
      scan_store<Q>(clv + node_row(t) * plane, v, 4 * sg, col0, ns, Pw);
      if (sg == 0) {
        float s[Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          const int l = Q * cg + j;
          s[j] = (x0[NS * T + l] + x1[NS * T + l]) + logf(lm[j]);
        }
        store_q<Q>(sc + node_row(t) * Pw + col0, s);
        if (held) store_q<Q>(held + NS * T + Q * cg, s);
      }
      __syncthreads();  // this step's clv is whole
      X = slot(t, 1);
    }
    float acc[4][Q];
    if constexpr (kStaged)
      scan_product_cols<T, Q>(pt, ld, X, NS, sg, cg, acc);
    else
      scan_product_rows<T, Q>(mat_of(t), NS, X, NS, sg, cg, acc);
    scan_store<Q>(pup + node_row(t) * plane, acc, 4 * sg, col0, ns, Pw);
    if (held) scan_put<T, Q>(held, acc, sg, cg);
    if constexpr (kStaged) {
      __syncthreads();  // the product is done with the matrix
      if (t + 1 < n_nodes)
        scan_fetch_transpose(pt, mat_of(t + 1), NS, ld, true, tid, nthr);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
}

template <int T>
__global__ void __maxnreg__(128)
    scan_down_wide(const int* __restrict__ child,
                   const float* __restrict__ pmats,
                   const float* __restrict__ pi,
                   const float* __restrict__ pup,
                   const float* __restrict__ sc, float* __restrict__ out,
                   float* __restrict__ sc_out, int n_otu, int n_int, int ns,
                   int P, int Pw) {
  constexpr int Q = kWideCols, D = kWideAhead;
  constexpr int CG = T / Q;
  constexpr int S = D + 1;
  const int NS = (ns + 3) & ~3, SG = NS / 4;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int cg = tid % CG, sg = tid / CG;
  const int C = gridDim.y, c = blockIdx.y, p0 = blockIdx.x * T;
  const int col0 = p0 + Q * cg;
  const int n_nodes = n_otu + n_int;
  const size_t plane = static_cast<size_t>(ns) * Pw;
  {
    const size_t z = blockIdx.z, nodes = static_cast<size_t>(n_nodes) * C;
    child += z * 2 * n_int;
    pmats += z * nodes * NS * NS;
    pup += z * nodes * plane;
    sc += z * nodes * Pw;
    out += z * nodes * plane;
    sc_out += z * nodes * Pw;
  }
  const int SL = (NS + 1) * T;
  extern __shared__ __align__(16) float smem[];
  float* slots = smem;              // [S][pup c0, pup c1, out u][NS + 1][T]
  float* red = slots + 3 * S * SL;  // [2][SG][T]
  auto slot = [&](int s, int k) { return slots + (3 * (s % S) + k) * SL; };
  auto node_row = [&](int u) { return static_cast<size_t>(u) * C + c; };
  auto mat_of = [&](int u) { return pmats + node_row(u) * NS * NS; };

  scan_check_children(child, n_otu, n_int, tid, nthr);
  for (int e = tid; e < scan_wide_smem_floats(NS, T, true, false);
       e += nthr)
    smem[e] = 0.0f;
  scan_zero_root<T>(out, sc_out, node_row(n_nodes - 1), plane, ns, p0, Pw, tid,
                    nthr);
  __syncthreads();

  // step s walks internal row i = n_int - 1 - s (node n_otu + i): the
  // root first.  fetch(s) is issued at step s - D: the out row of step
  // s's node, when one of steps s - D .. s - 1 makes it (its parent's),
  // is written into step s's stage by that step (held), not copied.
  auto fetch = [&](int s) {
    if (s < n_int) {
      const int i = n_int - 1 - s, u = n_otu + i;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int v = child[2 * i + k];
        scan_fetch_tile<T>(slot(s, k), pup + node_row(v) * plane + p0, ns, Pw,
                           tid, nthr);
        scan_fetch_tile<T>(slot(s, k) + NS * T, sc + node_row(v) * Pw + p0, 1,
                           Pw, tid, nthr);
      }
      if (s > 0 && !scan_handed(child, i, u, n_int, D)) {  // root: pi
        scan_fetch_tile<T>(slot(s, 2), out + node_row(u) * plane + p0, ns, Pw,
                           tid, nthr);
        scan_fetch_tile<T>(slot(s, 2) + NS * T, sc_out + node_row(u) * Pw + p0,
                           1, Pw, tid, nthr);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < D; ++s) fetch(s);
  for (int s = 0; s < n_int; ++s) {
    const int i = n_int - 1 - s, u = n_otu + i;
    const int ch[2] = {child[2 * i], child[2 * i + 1]};
    cp_async_wait<D - 1>();
    __syncthreads();
    fetch(s + D);
    float g[4][Q], gs[Q];
    if (s == 0) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 4 * sg + r;
        const float p = row < ns ? pi[c * ns + row] : 0.0f;
#pragma unroll
        for (int j = 0; j < Q; ++j) g[r][j] = p;
      }
#pragma unroll
      for (int j = 0; j < Q; ++j) gs[j] = 0.0f;
    } else {
      scan_product_cols<T, Q>(mat_of(u), NS, slot(s, 2), NS, sg, cg, g);
      load_q<Q>(slot(s, 2) + NS * T + Q * cg, gs);
    }
    // o[k]: child k's outside partial, g times the other child's pup
    float o[2][4][Q], lm[2][Q];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float b[4][Q];
      scan_get<T, Q>(b, slot(s, 1 - k), sg, cg);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < Q; ++j) o[k][r][j] = g[r][j] * b[r][j];
      scan_local_max<Q>(o[k], lm[k]);
    }
    if (s > 0) {
      // SG > 1 past 32 states: every thread is past its product here
      store_q<Q>(red + sg * T + Q * cg, lm[0]);
      store_q<Q>(red + (SG + sg) * T + Q * cg, lm[1]);
      __syncthreads();
      scan_column_max<T, Q>(lm[0], red, SG, cg);
      scan_column_max<T, Q>(lm[1], red + SG * T, SG, cg);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      // the step among the next D whose node is child k, if any
      float* held = nullptr;
#pragma unroll
      for (int j = 1; j <= D; ++j)
        if (s + j < n_int && ch[k] == u - j) held = slot(s + j, 2);
      if (s > 0)
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < Q; ++j) o[k][r][j] = o[k][r][j] / lm[k][j];
      scan_store<Q>(out + node_row(ch[k]) * plane, o[k], 4 * sg, col0, ns,
                    Pw);
      if (held) scan_put<T, Q>(held, o[k], sg, cg);
      if (sg == 0) {
        const float* xo = slot(s, 1 - k) + NS * T + Q * cg;  // sibling's sc
        float so[Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          so[j] = s == 0 ? xo[j] : (gs[j] + xo[j]) + logf(lm[k][j]);
        }
        store_q<Q>(sc_out + node_row(ch[k]) * Pw + col0, so);
        if (held) store_q<Q>(held + NS * T + Q * cg, so);
      }
    }
  }
  cp_async_wait<0>();
}

// Launch geometry at ns states: the padded state count NS (the rung of
// the ladder up to 32 states, else ns rounded up to 4), the tile,
// threads a block, the block's shared memory (0 where no block fits) and
// whether the up product stages its matrix.  Past 32 states the widest
// tile (32, 16, 8, 4) whose block keeps to kWideMaxThreads threads and
// kMaxSmem bytes, staged where that fits too.
struct ScanGeometry {
  int NS, tile, threads;
  size_t smem;
  bool staged;
};

inline int scan_rung(int ns) {
#define PHYML_SCAN_RUNG(NS_, ...) \
  if (ns <= NS_) return NS_;
  PHYML_LADDER(PHYML_SCAN_RUNG)
#undef PHYML_SCAN_RUNG
  return (ns + 3) & ~3;
}

inline ScanGeometry scan_geometry(int ns, bool down) {
  const int NS = scan_rung(ns);
  if (NS <= 32)
    return {NS, scan_warp_tile(NS), 32,
            sizeof(float) * scan_warp_smem_floats(NS, down), false};
  for (int T = kWideTile; T >= kWideCols; T /= 2) {
    const int threads = NS / 4 * (T / kWideCols);
    if (threads > kWideMaxThreads) continue;
    for (int staged = !down; staged >= 0; --staged) {
      const size_t bytes =
          sizeof(float) * scan_wide_smem_floats(NS, T, down, staged);
      if (bytes <= kMaxSmem) return {NS, T, threads, bytes, staged != 0};
    }
  }
  return {NS, kWideCols, NS / 4, 0, false};
}

template <typename K, typename... Args>
int scan_launch(K* kernel, const ScanGeometry& g, int Pw, int C, int R,
                cudaStream_t stream, Args... args) {
  if (g.smem == 0) return kUnsupported;
  cudaError_t err = allow_smem(kernel, g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Pw / g.tile, C, R);
  kernel<<<grid, g.threads, g.smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The wide body's kernel at the geometry's tile (and staging, up).
template <typename... Args>
int scan_up_wide_launch(const ScanGeometry& g, int Pw, int C, int R,
                        cudaStream_t st, Args... args) {
  switch (g.tile) {
    case 32:
      return g.staged
                 ? scan_launch(scan_up_wide<32, true>, g, Pw, C, R, st, args...)
                 : scan_launch(scan_up_wide<32, false>, g, Pw, C, R, st,
                               args...);
    case 16:
      return scan_launch(scan_up_wide<16, false>, g, Pw, C, R, st, args...);
    case 8:
      return scan_launch(scan_up_wide<8, false>, g, Pw, C, R, st, args...);
    default:
      return scan_launch(scan_up_wide<4, false>, g, Pw, C, R, st, args...);
  }
}

template <typename... Args>
int scan_down_wide_launch(const ScanGeometry& g, int Pw, int C, int R,
                          cudaStream_t st, Args... args) {
  switch (g.tile) {
    case 32:
      return scan_launch(scan_down_wide<32>, g, Pw, C, R, st, args...);
    case 16:
      return scan_launch(scan_down_wide<16>, g, Pw, C, R, st, args...);
    case 8:
      return scan_launch(scan_down_wide<8>, g, Pw, C, R, st, args...);
    default:
      return scan_launch(scan_down_wide<4>, g, Pw, C, R, st, args...);
  }
}

}  // namespace phyml

// A pass's kernel at ns states: the one-warp body at the rung of the
// ladder, past 32 states the wide body.
#define PHYML_SCAN_CASE(NS_, ...)                                           \
  case NS_:                                                                 \
    return phyml::scan_launch(WARP<NS_>, g, Pw, C, R, st, ARGS);
#define PHYML_SCAN_DISPATCH                                                 \
  if (ns < 1 || C < 1 || C > 65535 || R < 1 || R > 65535 || n_int < 1 ||    \
      P < 1 || Pw < P || Pw % 32)                                           \
    return phyml::kUnsupported;                                             \
  const cudaStream_t st = static_cast<cudaStream_t>(stream);                \
  switch (g.NS) {                                                           \
    PHYML_LADDER(PHYML_SCAN_CASE)                                           \
    default:                                                                \
      return WIDE(g, Pw, C, R, st, ARGS);                                   \
  }

// child [R, n_int, 2] int32, tips [n_otu, ns, P], pmats [R, n_nodes, C,
// NS, NS] (padded to geometry's NS) -> pup, clv [R, n_nodes, C, ns, Pw],
// sc [R, n_nodes, C, Pw] (R = 1 for one tree; Pw, a multiple of 32 from
// P on, the row stride of every tensor K7 writes or reads but the tips;
// the columns past P hold copies of the last pattern's).  0, a
// cudaError_t, or -1 for a shape with no block (more than 2,048 states,
// C or R over 65535).
extern "C" int phyml_scan_up(const int* child, const float* tips,
                             const float* pmats, float* pup, float* clv,
                             float* sc, int n_otu, int n_int, int ns, int C,
                             int P, int Pw, int R, void* stream) {
  const phyml::ScanGeometry g = phyml::scan_geometry(ns, false);
#define WARP phyml::scan_up_warp
#define WIDE phyml::scan_up_wide_launch
#define ARGS child, tips, pmats, pup, clv, sc, n_otu, n_int, ns, P, Pw
  PHYML_SCAN_DISPATCH
#undef WARP
#undef WIDE
#undef ARGS
}

// child, pmats as phyml_scan_up's; pi [C, ns]; pup, sc the up pass's ->
// out [R, n_nodes, C, ns, Pw], sc_out [R, n_nodes, C, Pw].
extern "C" int phyml_scan_down(const int* child, const float* pmats,
                               const float* pi, const float* pup,
                               const float* sc, float* out, float* sc_out,
                               int n_otu, int n_int, int ns, int C, int P,
                               int Pw, int R, void* stream) {
  const phyml::ScanGeometry g = phyml::scan_geometry(ns, true);
#define WARP phyml::scan_down_warp
#define WIDE phyml::scan_down_wide_launch
#define ARGS child, pmats, pi, pup, sc, out, sc_out, n_otu, n_int, ns, P, Pw
  PHYML_SCAN_DISPATCH
#undef WARP
#undef WIDE
#undef ARGS
}

// The launch geometry at ns states of the up (down = 0) or down pass:
// out[0..4] = NS, tile, threads, shared memory bytes (0: no block fits),
// 1 where the up product stages its matrix.
extern "C" int phyml_scan_geometry(int ns, int down, int* out) {
  if (ns < 1) return phyml::kUnsupported;
  const phyml::ScanGeometry g = phyml::scan_geometry(ns, down != 0);
  out[0] = g.NS;
  out[1] = g.tile;
  out[2] = g.threads;
  out[3] = static_cast<int>(g.smem);
  out[4] = g.staged;
  return 0;
}
