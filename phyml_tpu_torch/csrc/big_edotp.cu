// K5 (with K2's entry) past the ladder: the up sweep, the outside sweep
// and the per-edge eigen-basis dot products for any state count past
// the top rung (big_ffma.cuh gives the design and what bounds it).
//
// Replaces, past the top rung, phyml_tpu/ops/pallas_edotp.py:
// _edotp_stream_kernel (K5; the K2 entry, _edotp_kernel's, launches it
// too).  For every edge u it emits, as edotp.cuh,
//     d[u]    = (V^T O_u) * (V^-1 C_u)        [C, NSp, P]
//     sc_d[u] = (sc_out[u] + sc[u]) * ln 2    [C, P]
// the root row zeroed.  Grid (Pw / T pattern tiles, C classes, R
// stacked trees), a block of W warps on T = 16 W patterns of one class
// of one tree and a warp that stages the ring (ffma_warps); tree z's
// child table, P-matrices, d, sc_d and workspace lie at 64-bit base
// offsets (d passes 2^31 floats sooner at 160 states).
//
// Each warp, on its own 16 columns, step after step (no block barrier
// once the walk starts):
//
// * up step i (the root's too): its children's partials copied into its
//   tiles (tip rows, or the up sweep's workspace tile); q_k = P_k x_k,
//   kept in the workspace for the down step, and y = q_0 * q_1, stored
//   unscaled pair by pair with its column maxima kept; each column
//   rescaled into the workspace ws_clv[i] (row NSp the log2 scale);
// * down step i (root first): the children's partials and node i's
//   pushed outside partial g (pi at the root) copied in; the children's
//   outside partials o_0 = g * q_1 (in g's place) and o_1 = g * q_0 from
//   the up step's q_k, each rescaled over its column; then for each child
//   u = r_k the products V^T o_k and V^-1 x_k, whose product d[u] goes
//   to device memory from the registers, and for an internal child P_u^T
//   o_k, the outside partial its own down step starts from, into
//   ws_out[u].
//
// A down step so reads its q_k, the same float32 values as the up step's
// (same operands, same order of sums), instead of computing them again:
// 4 of a node's 9 to 10 products.
//
// Shared memory (big_edotp_smem, ffma_smem_floats): the mbarriers, the
// ring kFfmaStages x 2 pieces of 32 x 16, V and V^-1 where resident, and
// each warp's four tiles of 16 columns: 97 KB at 80 states (W = 4, V
// streamed, two blocks an SM), 113 KB at 64 (V resident), 177 KB at 160
// (one block an SM).
// The workspace is [n_int, C, 2 NSp + 1, Pw] twice: a node's partial
// (ws_clv) or pushed outside partial (ws_out), row NSp its log2 scale,
// then its q_0 (ws_clv) or q_1 (ws_out).  Each block checks the child
// table once and traps on a child outside [0, n_otu + i) in row i.
#include "big_ffma.cuh"

namespace phyml {

// The walks' epilogues, functors whose calls inline: the lane's rows of
// pair mp are 32 mp + 16 h + 4 rg + a, its columns 4 cg .. 4 cg + 3 of
// its warp's 16; a half pair's lanes of h = 1 store nothing.
__device__ __forceinline__ int ffma_row(int mp, int a) {
  const int lane = threadIdx.x;
  return mp * kFfmaPair + 16 * (lane >> 4) + 4 * ((lane >> 2) & 3) + a;
}

// An up step: y = q_0 * q_1 unscaled into the warp tile ob ([NSp][16])
// and its column maxima into cm; q_0 and q_1 into the workspace (q0, q1
// at the lane's columns, rows ld floats apart).
struct FfmaUpEpi {
  float* ob;
  float* q0;
  float* q1;
  size_t ld;
  float* cm;
  __device__ __forceinline__ void operator()(
      int mp, bool full, const float (&acc)[2][4][4]) const {
    if (!full && (threadIdx.x >> 4)) return;
    const int cg = threadIdx.x & 3;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = ffma_row(mp, a);
      float y[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        y[b] = acc[0][a][b] * acc[1][a][b];
        cm[b] = fmaxf(cm[b], y[b]);
      }
      *reinterpret_cast<float4*>(ob + r * kFfmaWarpCols + 4 * cg) =
          make_float4(y[0], y[1], y[2], y[3]);
      *reinterpret_cast<float4*>(q0 + r * ld) = make_float4(
          acc[0][a][0], acc[0][a][1], acc[0][a][2], acc[0][a][3]);
      *reinterpret_cast<float4*>(q1 + r * ld) = make_float4(
          acc[1][a][0], acc[1][a][1], acc[1][a][2], acc[1][a][3]);
    }
  }
};

// The edge dot products: d[u] = (V^T o) * (V^-1 x) from the registers
// into device memory (d_u at the lane's columns, rows ld floats apart,
// the first n of the lane's 4 columns inside the pattern axis).
struct FfmaDotEpi {
  float* d_u;
  size_t ld;
  int n;
  __device__ __forceinline__ void operator()(
      int mp, bool full, const float (&acc)[2][4][4]) const {
    if (!full && (threadIdx.x >> 4)) return;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float* row = d_u + static_cast<size_t>(ffma_row(mp, a)) * ld;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (b < n) row[b] = acc[0][a][b] * acc[1][a][b];
    }
  }
};

// An internal child's pushed outside partial P_u^T o into the workspace
// (h_u at the lane's columns, rows ld floats apart).
struct FfmaPushEpi {
  float* h_u;
  size_t ld;
  __device__ __forceinline__ void operator()(
      int mp, bool full, const float (&acc)[1][4][4]) const {
    if (!full && (threadIdx.x >> 4)) return;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(h_u +
                                 static_cast<size_t>(ffma_row(mp, a)) * ld) =
          make_float4(acc[0][a][0], acc[0][a][1], acc[0][a][2],
                      acc[0][a][3]);
  }
};

// two blocks an SM: at most 204 registers a thread
__global__ void __launch_bounds__(32 * (kFfmaMaxWarps + 1), 2)
    big_edotp_kernel(const int* __restrict__ child,
                     const float* __restrict__ tips,
                     const float* __restrict__ pmats,
                     const float* __restrict__ V,
                     const float* __restrict__ Vinv,
                     const float* __restrict__ pi, float* __restrict__ d,
                     float* __restrict__ scd, float* __restrict__ ws_clv,
                     float* __restrict__ ws_out, int n_otu, int n_int,
                     int NSp, int P, int Pw, int resident) {
  const size_t M = static_cast<size_t>(NSp) * NSp;
  {
    // my tree (grid.z) of a stack: its operands at 64-bit base offsets
    const size_t z = blockIdx.z, n_nodes = n_otu + n_int, C = gridDim.y;
    child += z * 2 * n_int;
    pmats += z * n_nodes * C * M;
    d += z * n_nodes * C * NSp * P;
    scd += z * n_nodes * C * P;
    ws_clv += z * n_int * C * (2 * NSp + 1) * Pw;
    ws_out += z * n_int * C * (2 * NSp + 1) * Pw;
  }
  extern __shared__ __align__(16) float smem[];
  // W warps on the tile's columns, and warp W, which stages the ring
  const int lane = threadIdx.x, wy = threadIdx.y, W = blockDim.y - 1;
  const int tid = wy * 32 + lane, nthr = 32 * (W + 1);
  const int C = gridDim.y, c = blockIdx.y;
  const int p0 = blockIdx.x * W * kFfmaWarpCols + wy * kFfmaWarpCols;
  const int n_nodes = n_otu + n_int;
  const size_t sP = P, sW = Pw;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // full, empty
  float* ring = smem + kFfmaBarFloats;
  float* Vt = ring + kFfmaStages * 2 * kFfmaItem;  // V: [k][out]
  float* Vn = Vt + M;                              // V^-1 (ffma_res_n)
  const int kTile = (NSp + 1) * kFfmaWarpCols;
  // my warp's tiles: the children's partials, g (then o_0), o_1
  float* xt = Vt + (resident ? 2 * M : 0) +
              static_cast<size_t>(wy) * (4 * kTile - kFfmaWarpCols);
  float* gt = xt + 2 * kTile;
  float* ob = gt + kTile;
  if (tid == 0) ffma_ring_init(bars, W);
  {
    bool bad = false;
    for (int i = tid; i < n_int; i += nthr)
      bad |= static_cast<unsigned>(child[2 * i]) >=
                 static_cast<unsigned>(n_otu + i) ||
             static_cast<unsigned>(child[2 * i + 1]) >=
                 static_cast<unsigned>(n_otu + i);
    if (__syncthreads_or(bad)) __trap();  // also: the barriers are set
  }
  const float* Vc = V + c * M;
  const float* Vic = Vinv + c * M;
  if (resident) {
    // V's rows as they are, V^-1's laid out by ffma_res_n
    for (int q = tid; q < NSp * NSp / 4; q += nthr) {
      const int r = q / (NSp / 4), k = 4 * (q - r * (NSp / 4));
      cp_async16(Vt + 4 * q, Vc + 4 * q);
      cp_async16(Vn + ffma_res_n(r, k, NSp), Vic + 4 * q);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  auto pm_of = [&](int u) {
    return pmats + (static_cast<size_t>(u) * C + c) * M;
  };
  if (wy == W) {
    // the staging warp: every walk's matrices in the reading warps' order
    FfmaStager sg{ring, bars, bars + kFfmaStages, NSp};
    for (int i = 0; i < n_int; ++i)
      sg.walk(pm_of(child[2 * i]), pm_of(child[2 * i + 1]), 2, 0u);
    for (int i = n_int - 1; i >= 0; --i) {
      const int u[2] = {child[2 * i], child[2 * i + 1]};
      for (int k = 0; k < 2; ++k) {
        if (!resident) sg.walk(Vc, Vic, 2, 1u);
        if (u[k] >= n_otu) sg.walk(pm_of(u[k]), nullptr, 1, 1u);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }
  FfmaReader rd{ring, bars, bars + kFfmaStages};
  const int h = lane >> 4, rg = (lane >> 2) & 3, cg = lane & 3;
  // a node's tile of my class and columns in a workspace (rows sW
  // apart), and the q_k it holds from row NSp + 1
  const size_t ws_class = static_cast<size_t>(2 * NSp + 1) * sW;
  auto ws_tile = [&](float* ws, int idx) {
    return ws + (static_cast<size_t>(idx) * C + c) * ws_class + p0;
  };
  auto q_tile = [&](float* ws, int idx) {
    return ws_tile(ws, idx) + static_cast<size_t>(NSp + 1) * sW + 4 * cg;
  };
  // child u's partial (tip rows and a zero scale row, or its tile of the
  // up sweep's workspace) into tile k
  auto fetch_x = [&](int k, int u) {
    if (u < n_otu)
      ffma_copy_tip(xt + k * kTile, tips + static_cast<size_t>(u) * NSp * sP,
                    sP, NSp, p0, P);
    else
      ffma_copy_tile(xt + k * kTile, ws_tile(ws_clv, u - n_otu), sW, NSp);
  };
  // the root row is meaningless: zeros
  {
    const size_t root = n_nodes - 1;
    for (int e = lane; e < kTile; e += 32) {
      const int r = e >> 4, p = p0 + (e & 15);
      if (p >= P) continue;
      if (r < NSp)
        d[((root * C + c) * NSp + r) * sP + p] = 0.0f;
      else
        scd[(root * C + c) * sP + p] = 0.0f;
    }
  }
  // my tile's element (row r, my four columns) of a warp tile
  auto at = [&](float* t, int r) {
    return reinterpret_cast<float4*>(t + r * kFfmaWarpCols + 4 * cg);
  };
  const int n_mp = (NSp + kFfmaPair - 1) / kFfmaPair;

  for (int i = 0; i < n_int; ++i) {  // up sweep, the root's too
    const int u0 = child[2 * i], u1 = child[2 * i + 1];
    __syncwarp();  // every lane is done with the last step's tiles
    fetch_x(0, u0);
    fetch_x(1, u1);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    float cm[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const float* const res[2] = {nullptr, nullptr};
    const float* const x[2] = {xt, xt + kTile};
    float* q0 = q_tile(ws_clv, i);
    float* q1 = q_tile(ws_out, i);
    ffma_walk<2, 0u>(rd, res, x, NSp, FfmaUpEpi{ob, q0, q1, sW, cm});
    const float4 s0 = *at(xt, NSp), s1 = *at(xt + kTile, NSp);
    float s[4] = {s0.x + s1.x, s0.y + s1.y, s0.z + s1.z, s0.w + s1.w};
    float f[4];
    ffma_factors(cm, s, f);
    float* dst = ws_tile(ws_clv, i) + 4 * cg;
    for (int mp = 0; mp < n_mp; ++mp) {
      if ((mp + 1) * kFfmaPair > NSp && h) continue;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = ffma_row(mp, a);
        const float4 y = *at(ob, r);
        *reinterpret_cast<float4*>(dst + r * sW) =
            make_float4(y.x * f[0], y.y * f[1], y.z * f[2], y.w * f[3]);
      }
    }
    if (h == 0 && rg == 0)
      *reinterpret_cast<float4*>(dst + NSp * sW) =
          make_float4(s[0], s[1], s[2], s[3]);
  }

  for (int i = n_int - 1; i >= 0; --i) {  // down sweep, root first
    const int u[2] = {child[2 * i], child[2 * i + 1]};
    __syncwarp();  // every lane is done with the last step's tiles
    fetch_x(0, u[0]);
    fetch_x(1, u[1]);
    if (i < n_int - 1) {
      ffma_copy_tile(gt, ws_tile(ws_out, i), sW, NSp);
    } else {
      const float* pi_c = pi + static_cast<size_t>(c) * NSp;
      for (int e = lane; e < kTile; e += 32)
        gt[e] = e < NSp * kFfmaWarpCols ? pi_c[e >> 4] : 0.0f;
    }
    cp_async_commit();
    // the children's outside partials o_k = g * q_(1-k), unscaled, from
    // the up step's q_k
    float cm0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cm1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
      const float* q0 = q_tile(ws_clv, i);
      const float* q1 = q_tile(ws_out, i);
      cp_async_wait<0>();
      __syncwarp();
      for (int mp = 0; mp < n_mp; ++mp) {
        if ((mp + 1) * kFfmaPair > NSp && h) continue;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = ffma_row(mp, a);
          const float4 gv = *at(gt, r);
          const float4 v0 = *reinterpret_cast<const float4*>(q0 + r * sW);
          const float4 v1 = *reinterpret_cast<const float4*>(q1 + r * sW);
          const float g[4] = {gv.x, gv.y, gv.z, gv.w};
          const float a0[4] = {v0.x, v0.y, v0.z, v0.w};
          const float a1[4] = {v1.x, v1.y, v1.z, v1.w};
          float o0[4], o1[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            o0[b] = g[b] * a1[b];
            o1[b] = g[b] * a0[b];
            cm0[b] = fmaxf(cm0[b], o0[b]);
            cm1[b] = fmaxf(cm1[b], o1[b]);
          }
          *at(gt, r) = make_float4(o0[0], o0[1], o0[2], o0[3]);
          *at(ob, r) = make_float4(o1[0], o1[1], o1[2], o1[3]);
        }
      }
    }
    // each o_k rescaled over its column; its scales into sc_d and, for
    // an internal child, the scale row of its pushed outside partial
    {
      const float4 sgv = *at(gt, NSp);
      const float4 sx0 = *at(xt, NSp), sx1 = *at(xt + kTile, NSp);
      const float sg[4] = {sgv.x, sgv.y, sgv.z, sgv.w};
      const float sx[2][4] = {{sx0.x, sx0.y, sx0.z, sx0.w},
                              {sx1.x, sx1.y, sx1.z, sx1.w}};
      float sco[2][4], f[2][4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sco[0][b] = sg[b] + sx[1][b];
        sco[1][b] = sg[b] + sx[0][b];
      }
      ffma_factors(cm0, sco[0], f[0]);
      ffma_factors(cm1, sco[1], f[1]);
      for (int mp = 0; mp < n_mp; ++mp) {
        if ((mp + 1) * kFfmaPair > NSp && h) continue;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = ffma_row(mp, a);
          float4* o0 = at(gt, r);
          float4* o1 = at(ob, r);
          const float4 v0 = *o0, v1 = *o1;
          *o0 = make_float4(v0.x * f[0][0], v0.y * f[0][1], v0.z * f[0][2],
                            v0.w * f[0][3]);
          *o1 = make_float4(v1.x * f[1][0], v1.y * f[1][1], v1.z * f[1][2],
                            v1.w * f[1][3]);
        }
      }
      if (h == 0 && rg == 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (p0 + 4 * cg + b < P)
              scd[(static_cast<size_t>(u[k]) * C + c) * sP + p0 + 4 * cg +
                  b] = (sco[k][b] + sx[k][b]) * kLn2;
          if (u[k] >= n_otu)
            *reinterpret_cast<float4*>(ws_tile(ws_out, u[k] - n_otu) +
                                       NSp * sW + 4 * cg) =
                make_float4(sco[k][0], sco[k][1], sco[k][2], sco[k][3]);
        }
      }
    }
    __syncwarp();  // o_0 and o_1 rescaled
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const float* ok = k == 0 ? gt : ob;
      {
        // d[u] = (V^T o_k) * (V^-1 x_k)
        float* d_u = d + (static_cast<size_t>(u[k]) * C + c) * NSp * sP +
                     p0 + 4 * cg;
        const int n_cols = min(4, max(0, P - p0 - 4 * cg));
        const float* const res[2] = {resident ? Vt : nullptr,
                                     resident ? Vn : nullptr};
        const float* const x[2] = {ok, xt + k * kTile};
        ffma_walk<2, 1u>(rd, res, x, NSp, FfmaDotEpi{d_u, sP, n_cols});
      }
      if (u[k] >= n_otu) {
        // an internal child's outside partial pushed through its own
        // edge, P_u^T o_k, which its own down step starts from
        float* h_u = ws_tile(ws_out, u[k] - n_otu) + 4 * cg;
        const float* const res[1] = {nullptr};
        const float* const x[1] = {ok};
        ffma_walk<1, 1u>(rd, res, x, NSp, FfmaPushEpi{h_u, sW});
      }
    }
  }
  cp_async_wait<0>();
}

// bytes of shared memory of one block (the layout of big_edotp_kernel)
size_t big_edotp_smem(int NSp) {
  return ffma_smem_floats(NSp, ffma_warps(NSp), ffma_resident(NSp)) *
         sizeof(float);
}

int big_edotp_launch(const int* child, const float* tips,
                     const float* pmats, const float* V, const float* Vinv,
                     const float* pi, float* d, float* scd, float* ws_clv,
                     float* ws_out, int n_otu, int n_int, int NSp, int C,
                     int P, int Pw, int R, cudaStream_t stream) {
  const int W = ffma_warps(NSp), T = W * kFfmaWarpCols;
  if (!big_width(NSp) || W == 0 || Pw % T != 0 || Pw < P || Pw - P >= T)
    return kUnsupported;
  const size_t smem = big_edotp_smem(NSp);
  cudaError_t err = allow_smem(big_edotp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, W + 1), grid(Pw / T, C, R);
  big_edotp_kernel<<<grid, block, smem, stream>>>(
      child, tips, pmats, V, Vinv, pi, d, scd, ws_clv, ws_out, n_otu, n_int,
      NSp, P, Pw, ffma_resident(NSp) ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

int big_edotp_occupancy(int NSp, int* blocks_per_sm) {
  const int W = ffma_warps(NSp);
  if (!big_width(NSp) || W == 0) return kUnsupported;
  const size_t smem = big_edotp_smem(NSp);
  cudaError_t err = allow_smem(big_edotp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, big_edotp_kernel, 32 * (W + 1), smem));
}

}  // namespace phyml
