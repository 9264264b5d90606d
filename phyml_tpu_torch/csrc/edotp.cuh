// K2 and K5: up sweep + outside sweep + per-edge eigen-basis dot
// products, one kernel body for both.
//
// Replaces phyml_tpu/ops/pallas_edotp.py:_edotp_kernel (K2, wrapper
// edge_dotprods_pallas) and _edotp_stream_kernel (K5, wrapper
// edge_dotprods_pallas_stream).  For every edge u it emits
//     d[u]    = (V^T O_u) * (V^-1 C_u)        [C, ns, P]
//     sc_d[u] = (sc_out[u] + sc[u]) * ln 2    [C, P]
// which the branch-length Newton turns into lnL(t) and its derivatives
// for every edge at once.  A postorder sweep stores the rescaled
// internal partials C_u; a reverse sweep forms the outside partials O_u
// of each node's children and writes their d/sc_d.  The root row is
// zeroed; the zero-length root child's row is meaningless (callers mask
// it).  K2 (edotp.cu) and K5 (edotp_stream.cu) are this one body under
// two names: staging the P-matrices in the ring, which K5 was written
// for, was also faster at DNA than K2's reads in place through L1
// (measured on an H100, PERF.md), so both routes of
// likelihood.kernel_route run it.
//
// What bounds it on the H100: at 128 x 4096 amino acids, C = 4, about
// 14 GFLOP of FP32 FMAs (0.22 ms at the FP32 peak; the down sweep
// pushes each child again rather than store the pushes) and about 1 GB
// of device memory (d written once; the workspace written and read
// once per sweep: 0.29 ms at the HBM rate).  At DNA the work is small
// and the 254 dependent steps, each a chain of a few hundred mostly
// integer and shared-memory instructions, set the time.  The design:
//
// * One block is one warp: one pattern tile of one class (grid = tiles
//   x C).  Classes share nothing but the tip rows, so every block runs
//   its own pipeline and synchronises only with __syncwarp; no block
//   barrier couples four classes' chains.  Tile T = 32 patterns at
//   ns = 4 and 16 at ns = 20: 472 and 988 one-warp blocks at the bench
//   shapes, 3.6 and 7.5 per SM on 132 SMs.
// * Register tiles, as K3 (clv.cu): each thread owns R states x Q
//   patterns of a column split over G = ns / R lanes (ns = 20: R = 5,
//   G = 4, Q = 2; ns = 4: R = 4, G = 1, Q = 1), every matvec a
//   tile_matmul from shared memory (common.cuh), the rescale's column
//   max exchanged by xor shuffles (rescale_tile).
// * Staged operands: each step's children's partials (tip rows, or the
//   workspace tile of an internal node), the outside partial its down
//   step starts from and the children's P-matrices are copied with
//   cp.async into one stage of a two-stage ring while the step before
//   computes, so no step starts with a dependent load from device
//   memory.  Each lane's share of the copies is fixed (offsets taken
//   once, not per step).  V^T and V^-1 are staged once.
// * Kept on chip: a step's result that the next step reads (in
//   postorder, most nodes directly follow a child) is written straight
//   into that step's ring stage, not read back from the workspace; the
//   down sweep's outside partial of such a child is never stored.
// * The down sweep stores, for an internal child k, its outside
//   partial already pushed through its own edge, P_k^T O_k (the "g"
//   its own down step starts from), with that step's P_k in the ring:
//   the parent's P-matrix is never staged.
// * The workspace is [n_int, C, ns + 1, Pw] twice (partials, pushed
//   outside partials), row ns holding a column's log2 scale, Pw the
//   pattern count rounded up to T, so a class's tile of a node is
//   ns + 1 rows of 16-byte pieces.
// * Each block checks the child table once, a row per lane, and traps
//   on a child outside [0, n_otu + i) for row i (the postorder the
//   sweeps rely on): the workspace is indexed by node.
// * A tree axis: grid.z = R stacked trees of one taxon set (the rapid
//   bootstrap's replicates, which phyml_tpu runs as this kernel under
//   jax.vmap, phyml_tpu/optim/blen.py:139-159).  Block z walks tree z:
//   its own child table [n_int, 2], P-matrices, d, sc_d and workspace,
//   each at a base offset computed in 64 bits (d alone passes 2^31
//   floats at protein R = 32), and checks its own child table; the tips,
//   V, V^-1 and pi are shared.  Blocks of one tree share nothing with
//   another's, so the one launch of R trees is R independent sweeps.
//
// * Other state counts: one instantiation per rung of ladder.cuh, its
//   R x Q tile from the table (T = 32 patterns at ns = 4 and 8, 16 up to
//   24, 8 at 32: a down step holds about six R x Q register tiles, so
//   the rungs keep R x Q near ns = 20's 10); the wrapper pads ns to the
//   rung.
//
// Dynamic shared memory per block (kEdotpSmem): ns = 20 20.2 KB, ns = 4
// 5.1 KB, ns = 32 33.0 KB (V^T, V^-1 and the P-matrix ring are 6 ns^2
// floats).  Registers from ptxas
// (chip_smoke.py prints them and the blocks per SM the runtime grants).
#pragma once

#include "common.cuh"
#include "big_launch.cuh"

namespace phyml {

// R states and Q patterns per thread at each rung (ladder.cuh)
template <int NS>
constexpr int kEdotpRows = Rung<NS>::kEdotpRows;
template <int NS>
constexpr int kEdotpCols = Rung<NS>::kEdotpCols;

// patterns one warp covers, the block's pattern tile (ns = 4: 32,
// ns = 20: 16, ns = 60: 8)
template <int NS>
constexpr int kEdotpTile = 32 / (NS / kEdotpRows<NS>) * kEdotpCols<NS>;

// steps a step's operands are copied ahead of it; the ring has
// kEdotpAhead + 1 stages
constexpr int kEdotpAhead = 1;

// floats of shared memory of one block (one class): V^T and V^-1, the
// ring of P-matrices, partials and outside partials, the two outside
// partials of a down step
template <int NS>
constexpr int kEdotpSmem = (2 + 2 * (kEdotpAhead + 1)) * NS * NS +
                           3 * (kEdotpAhead + 1) * (NS + 1) * kEdotpTile<NS> +
                           2 * NS * kEdotpTile<NS>;

template <int NS>
__device__ __forceinline__ void edge_dotprods_body(
    const int* __restrict__ child, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ V,
    const float* __restrict__ Vinv, const float* __restrict__ pi,
    float* __restrict__ d, float* __restrict__ scd,
    float* __restrict__ ws_clv, float* __restrict__ ws_out, int n_otu,
    int n_int, int P, int Pw) {
  {
    // my tree (grid.z) of a stack: its operands at 64-bit base offsets
    const size_t z = blockIdx.z, n_nodes = n_otu + n_int;
    const size_t C = gridDim.y;
    child += z * 2 * n_int;
    pmats += z * n_nodes * C * NS * NS;
    d += z * n_nodes * C * NS * P;
    scd += z * n_nodes * C * P;
    ws_clv += z * n_int * C * (NS + 1) * Pw;
    ws_out += z * n_int * C * (NS + 1) * Pw;
  }
  constexpr int R = kEdotpRows<NS>, G = NS / R, Q = kEdotpCols<NS>;
  constexpr int T = kEdotpTile<NS>;
  constexpr int D = kEdotpAhead, S = D + 1;
  constexpr int M = NS * NS;          // floats of one class's P-matrix
  constexpr int kCol = (NS + 1) * T;  // one class's tile, scale row last
  static_assert(32 % T == 0 && T % 4 == 0, "a tile row is 1-8 lanes' work");
  extern __shared__ __align__(16) float smem[];  // kEdotpSmem<NS> floats
  const int C = gridDim.y, c = blockIdx.y;  // a block (one warp) per class
  const int lane = threadIdx.x;
  const int g = lane % G;       // my state group: states g*R .. g*R+R-1
  const int lp = lane / G * Q;  // my first pattern in the tile
  const int p0 = blockIdx.x * T;
  const int mat = C * M;        // floats of one node's P-matrices
  const size_t sP = P, sW = Pw;
  const size_t ws_node = static_cast<size_t>(C) * (NS + 1) * sW;
  float* Vt = smem;                       // [NS][NS], V transposed
  float* Vi = Vt + M;                     // [NS][NS]
  float* pm_ring = Vi + M;                // [S][2][NS][NS]
  float* x_ring = pm_ring + 2 * S * M;    // [S][2][NS+1][T]
  float* g_ring = x_ring + 2 * S * kCol;  // [S][NS+1][T]
  float* o_tile = g_ring + S * kCol;      // [2][NS][T]
  // steps: up 0..n_int-1 (the root's computes nothing), D-1 empty
  // steps, then down from the root
  const int first_down = n_int + D - 1;
  const int n_steps = first_down + n_int;

  {
    const unsigned n_tip = n_otu;
    bool bad = false;
    for (int i = lane; i < n_int; i += 32)
      bad |= static_cast<unsigned>(child[2 * i]) >= n_tip + i ||
             static_cast<unsigned>(child[2 * i + 1]) >= n_tip + i;
    if (__any_sync(0xffffffffu, bad)) __trap();
  }
  for (int e = lane; e < M; e += 32) {
    Vt[(e % NS) * NS + e / NS] = V[c * M + e];
    Vi[e] = Vinv[c * M + e];
  }
  // the root row is meaningless: zeros
  {
    const size_t root = n_otu + n_int - 1;
    for (int e = lane; e < kCol; e += 32) {
      const int r = e / T, p = p0 + e % T;
      if (p >= P) continue;
      if (r < NS)
        d[((root * C + c) * NS + r) * sP + p] = 0.0f;
      else
        scd[(root * C + c) * sP + p] = 0.0f;
    }
  }

  // per-lane parts of the copies, the same at every step: a tile row
  // of T floats is T/4 16-byte pieces, piece k = lane + 32m sits at
  // 4k in the slot and at row k/(T/4), column 4(k%(T/4)) of the
  // workspace; tip element e = lane + 32m at row e/T, column e%T
  constexpr int kPieces = (NS + 1) * T / 4;  // of a class's tile
  const size_t ws_lane = (c * (NS + 1) + lane / (T / 4)) * sW + p0 +
                         4 * (lane % (T / 4));
  const size_t tip_lane = static_cast<size_t>(lane / T) * P +
                          min(p0 + lane % T, P - 1);
  auto is_up = [&](int t) { return t < n_int; };
  auto is_down = [&](int t) { return t >= first_down && t < n_steps; };
  auto node_of = [&](int t) { return is_up(t) ? t : n_steps - 1 - t; };
  auto stage_of = [](int t) { return static_cast<unsigned>(t) % S; };
  // children of step t's node; (-1, -1) for an empty step
  auto load_row = [&](int t, int (&r)[2]) {
    r[0] = r[1] = -1;
    if (is_up(t) || is_down(t)) {
      const int i = node_of(t);
      r[0] = child[2 * i];
      r[1] = child[2 * i + 1];
    }
  };
  // one class's tile of a node from the workspace into a ring slot
  auto copy_tile = [&](float* slot, const float* ws, int node) {
#pragma unroll
    for (int m = 0; m < (kPieces + 31) / 32; ++m)
      if (lane + 32 * m < kPieces)
        cp_async16(slot + 4 * (lane + 32 * m),
                   ws + node * ws_node + ws_lane + m * (128 / T) * sW);
  };
  // issue my class's copies of step t's operands (children r) into
  // ring stage t % S.  What a step at most D before t produces and t
  // reads, that step writes there itself: an up step's internal child
  // made at step t-D or later, a down step's outside partial when its
  // parent's step is at most D before (g_handed).
  auto fetch = [&](int t, const int (&r)[2], bool g_handed) {
    const int stage = stage_of(t);
    if (is_up(t) || is_down(t)) {
      const int i = node_of(t);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int u = r[k];
        float* pm = pm_ring + (2 * stage + k) * M;
        const float* src = pmats + static_cast<size_t>(u) * mat + c * M;
#pragma unroll
        for (int m = 0; m < (M / 4 + 31) / 32; ++m)
          if (lane + 32 * m < M / 4)
            cp_async16(pm + 4 * (lane + 32 * m), src + 4 * (lane + 32 * m));
        float* slot = x_ring + (2 * stage + k) * kCol;
        if (u < n_otu) {
          const float* row = tips + static_cast<size_t>(u) * NS * P + tip_lane;
#pragma unroll
          for (int m = 0; m < NS * T / 32; ++m)
            cp_async4(slot + lane + 32 * m, row + m * (32 / T) * sP);
        } else if (!(is_up(t) && u - n_otu >= i - D)) {
          copy_tile(slot, ws_clv, u - n_otu);
        }
      }
      if (is_down(t) && i < n_int - 1 && !g_handed)
        copy_tile(g_ring + stage * kCol, ws_out, i);
    }
    cp_async_commit();  // possibly empty: one group per step
  };
  auto xcol = [&](int stage, int k) -> const float* {
    return x_ring + (2 * stage + k) * kCol + lp;
  };
  auto pmat = [&](int stage, int k) -> const float* {
    return pm_ring + (2 * stage + k) * M;
  };

  // up step t (node n_otu + t, children r0, r1): the rescaled product
  // of the two pushes, into the workspace and, when the parent's step
  // is at most D ahead, into its ring stage (`held`)
  auto up_step = [&](int t, int r0, int r1, float* held) {
    const int stage = stage_of(t), i = t;
    const int r[2] = {r0, r1};
    float acc[2][R][Q], s[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) s[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* x = xcol(stage, k);
      if (r[k] >= n_otu) {
        float sk[Q];
        load_q<Q>(x + NS * T, sk);
#pragma unroll
        for (int j = 0; j < Q; ++j) s[j] += sk[j];
      }
      tile_matmul<NS, R, Q>(pmat(stage, k) + g * R * NS, x, T, acc[k]);
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[0][a][j] *= acc[1][a][j];
    rescale_tile<G, R, Q>(acc[0], s);
    float* dst = ws_clv + i * ws_node + c * (NS + 1) * sW + p0 + lp;
#pragma unroll
    for (int a = 0; a < R; ++a) store_q<Q>(dst + (g * R + a) * sW, acc[0][a]);
    if (g == 0) store_q<Q>(dst + NS * sW, s);
    if (held) {
#pragma unroll
      for (int a = 0; a < R; ++a)
        store_q<Q>(held + (g * R + a) * T, acc[0][a]);
      if (g == 0) store_q<Q>(held + NS * T, s);
    }
  };

  // down step t (node n_otu + i, children r0, r1): each child's outside
  // partial (g times the other child's push, rescaled), its d and sc_d,
  // and for an internal child that partial pushed through its own edge,
  // into the ring stage of the child's step when that is at most D
  // ahead, else into the workspace
  auto down_step = [&](int t, int i, int r0, int r1) {
    const int stage = stage_of(t);
    const int r[2] = {r0, r1};
    float q[2][R][Q], sx[2][Q];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* x = xcol(stage, k);
      if (r[k] >= n_otu)
        load_q<Q>(x + NS * T, sx[k]);
      else
#pragma unroll
        for (int j = 0; j < Q; ++j) sx[k][j] = 0.0f;
      tile_matmul<NS, R, Q>(pmat(stage, k) + g * R * NS, x, T, q[k]);
    }
    float gv[R][Q], sg[Q];
    if (i == n_int - 1) {
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int j = 0; j < Q; ++j) gv[a][j] = pi[c * NS + g * R + a];
#pragma unroll
      for (int j = 0; j < Q; ++j) sg[j] = 0.0f;
    } else {
      const float* gs = g_ring + stage * kCol + lp;
#pragma unroll
      for (int a = 0; a < R; ++a) load_q<Q>(gs + (g * R + a) * T, gv[a]);
      load_q<Q>(gs + NS * T, sg);
    }
    float sco[2][Q];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float o[R][Q];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int j = 0; j < Q; ++j) o[a][j] = gv[a][j] * q[1 - k][a][j];
#pragma unroll
      for (int j = 0; j < Q; ++j) sco[k][j] = sg[j] + sx[1 - k][j];
      rescale_tile<G, R, Q>(o, sco[k]);
      float* ot = o_tile + k * NS * T + lp;
#pragma unroll
      for (int a = 0; a < R; ++a) store_q<Q>(ot + (g * R + a) * T, o[a]);
    }
    __syncwarp();  // a column's states come from the G lanes of my warp
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int u = r[k];
      float* ot = o_tile + k * NS * T + lp;
      float a[R][Q], b[R][Q];
      tile_matmul<NS, R, Q>(Vt + g * R * NS, ot, T, a);
      tile_matmul<NS, R, Q>(Vi + g * R * NS, xcol(stage, k), T, b);
      if (u >= n_otu) {
        float h[R][Q];
        tile_matmul_t<NS, R, Q>(pmat(stage, k) + g * R, ot, T, h);
        const int ahead = i - (u - n_otu);  // steps to the child's own
        if (ahead <= D) {
          float* dst = g_ring + stage_of(t + ahead) * kCol + lp;
#pragma unroll
          for (int e = 0; e < R; ++e)
            store_q<Q>(dst + (g * R + e) * T, h[e]);
          if (g == 0) store_q<Q>(dst + NS * T, sco[k]);
        } else {
          float* dst = ws_out + (u - n_otu) * ws_node + c * (NS + 1) * sW +
                       p0 + lp;
#pragma unroll
          for (int e = 0; e < R; ++e)
            store_q<Q>(dst + (g * R + e) * sW, h[e]);
          if (g == 0) store_q<Q>(dst + NS * sW, sco[k]);
        }
      }
      const size_t node_row = (static_cast<size_t>(u) * C + c) * NS;
#pragma unroll
      for (int j = 0; j < Q; ++j)
        if (g == 0 && p0 + lp + j < P)
          scd[(static_cast<size_t>(u) * C + c) * sP + p0 + lp + j] =
              (sco[k][j] + sx[k][j]) * kLn2;
      if constexpr (G == 1 && Q == 1) {
        // a lane per pattern: each row is stored by 32 adjacent lanes
        if (p0 + lp < P)
#pragma unroll
          for (int e = 0; e < R; ++e)
            d[(node_row + e) * sP + p0 + lp] = a[e][0] * b[e][0];
      } else {
        // d's rows start anywhere (P is odd at the bench shapes), and a
        // lane holds R states x Q patterns: the tile goes through o's
        // place in shared memory so that each store instruction writes
        // whole runs of T adjacent patterns
        __syncwarp();  // every lane is done reading o
#pragma unroll
        for (int e = 0; e < R; ++e) {
          float v[Q];
#pragma unroll
          for (int j = 0; j < Q; ++j) v[j] = a[e][j] * b[e][j];
          store_q<Q>(ot + (g * R + e) * T, v);
        }
        __syncwarp();
        const float* tile_d = o_tile + k * NS * T;
#pragma unroll
        for (int m = 0; m < NS * T / 32; ++m) {
          const int e = lane + 32 * m, col = e % T;
          if (p0 + col < P)
            d[(node_row + e / T) * sP + p0 + col] = tile_d[e];
        }
      }
    }
  };

  // win[j]: the children of step t + j
  int win[D + 1][2], later[2];
#pragma unroll
  for (int j = 0; j <= D; ++j) load_row(j, win[j]);
  __syncwarp();  // V^T and V^-1 are staged
#pragma unroll
  for (int j = 0; j < D; ++j) fetch(j, win[j], false);  // up steps
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<D - 1>();  // my copies of step t have landed
    __syncwarp();            // ... and my warp's, with the writes of the
                             // steps before; stage (t-1) % S is free
    {
      // step t+D's outside partial is handed over when its parent's
      // step is one of t .. t+D-1
      const int want = n_otu + node_of(t + D);
      bool handed = false;
#pragma unroll
      for (int j = 0; j < D; ++j)
        handed |= is_down(t + j) && (win[j][0] == want || win[j][1] == want);
      fetch(t + D, win[D], handed);
    }
    load_row(t + D + 1, later);
    if (is_up(t)) {
      if (t < n_int - 1) {  // the root's partial is never read
        float* held = nullptr;
#pragma unroll
        for (int j = 1; j <= D; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k)
            if (is_up(t + j) && win[j][k] == n_otu + t)
              held = x_ring + (2 * stage_of(t + j) + k) * kCol + lp;
        up_step(t, win[0][0], win[0][1], held);
      }
    } else if (is_down(t)) {
      down_step(t, node_of(t), win[0][0], win[0][1]);
    }
#pragma unroll
    for (int j = 0; j < D; ++j)
      win[j][0] = win[j + 1][0], win[j][1] = win[j + 1][1];
    win[D][0] = later[0], win[D][1] = later[1];
  }
  cp_async_wait<0>();
}

template <int NS, typename K>
int launch_edotp(K* kernel, const int* child, const float* tips,
                 const float* pmats, const float* V, const float* Vinv,
                 const float* pi, float* d, float* scd, float* ws_clv,
                 float* ws_out, int n_otu, int n_int, int C, int P, int Pw,
                 int R, cudaStream_t stream) {
  constexpr int T = kEdotpTile<NS>;
  constexpr size_t smem = kEdotpSmem<NS> * sizeof(float);
  if (Pw % T != 0 || Pw < P || Pw - P >= T || smem > kMaxSmem)
    return kUnsupported;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32), grid(Pw / T, C, R);
  kernel<<<grid, block, smem, stream>>>(child, tips, pmats, V, Vinv, pi, d,
                                        scd, ws_clv, ws_out, n_otu, n_int, P,
                                        Pw);
  return static_cast<int>(cudaGetLastError());
}

template <int NS, typename K>
int edotp_occupancy(K* kernel, int* blocks_per_sm) {
  constexpr size_t smem = kEdotpSmem<NS> * sizeof(float);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, 32, smem));
}

}  // namespace phyml

// One extern "C" launcher and one occupancy query per kernel, a case per
// rung of ladder.cuh and, past its top, K5's big body (big_edotp.cu: a
// state count padded to a multiple of 16, 16 patterns a warp) for both
// (-1 for another ns, or a pattern width Pw that is not P rounded up to
// the tile); R stacked trees (1 for one tree), each with its own child
// table, P-matrices, outputs and workspace.  The including file defines
// PHYML_EDOTP_KERNEL (its kernel template) first.
#define PHYML_EDOTP_CASE(NS, ...)                                          \
  case NS:                                                                 \
    return phyml::launch_edotp<NS>(PHYML_EDOTP_KERNEL<NS>, child, tips,    \
                                   pmats, V, Vinv, pi, d, scd, ws_clv,     \
                                   ws_out, n_otu, n_int, C, P, Pw, R, st);
#define PHYML_EDOTP_OCC_CASE(NS, ...) \
  case NS:                            \
    return phyml::edotp_occupancy<NS>(PHYML_EDOTP_KERNEL<NS>, blocks_per_sm);
#define PHYML_EDOTP_ENTRY(FN)                                                 \
  extern "C" int FN(const int* child, const float* tips, const float* pmats, \
                    const float* V, const float* Vinv, const float* pi,       \
                    float* d, float* scd, float* ws_clv, float* ws_out,       \
                    int n_otu, int n_int, int ns, int C, int P, int Pw,       \
                    int R, void* stream) {                                    \
    if (C < 1 || C > 65535 || n_int < 1 || R < 1 || R > 65535)               \
      return phyml::kUnsupported;                                             \
    const cudaStream_t st = static_cast<cudaStream_t>(stream);               \
    switch (ns) {                                                             \
      PHYML_LADDER(PHYML_EDOTP_CASE)                                          \
      default: /* past the ladder: K5's big body (big_edotp.cu) */            \
        return phyml::big_edotp_launch(child, tips, pmats, V, Vinv, pi, d,    \
                                       scd, ws_clv, ws_out, n_otu, n_int,     \
                                       ns, C, P, Pw, R, st);                  \
    }                                                                         \
  }                                                                           \
  extern "C" int FN##_occupancy(int ns, int* blocks_per_sm) {                 \
    switch (ns) {                                                             \
      PHYML_LADDER(PHYML_EDOTP_OCC_CASE)                                      \
      default:                                                                \
        return phyml::big_edotp_occupancy(ns, blocks_per_sm);                 \
    }                                                                         \
  }
