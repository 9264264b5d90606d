// K5 (with K2's entry) past the ladder: the up sweep, the outside sweep
// and the per-edge eigen-basis dot products for any state count past 64
// (big_ffma.cuh gives the panel design and what bounds it).
//
// Replaces, past 64 states, phyml_tpu/ops/pallas_edotp.py:
// _edotp_stream_kernel (K5; the K2 entry, _edotp_kernel's, launches it
// too).  For every edge u it emits, as edotp.cuh,
//     d[u]    = (V^T O_u) * (V^-1 C_u)        [C, NSp, P]
//     sc_d[u] = (sc_out[u] + sc[u]) * ln 2    [C, P]
// the root row zeroed.  Grid (Pw / 16 pattern tiles, C classes, R stacked
// trees), a block of W warps (ffma_warps) on one tile of one class of one
// tree; tree z's child table, P-matrices, d, sc_d and workspace lie at
// 64-bit base offsets (d passes 2^31 floats sooner at 160 states).
//
// Each step copies its operand tiles from device memory into shared
// memory (the children's partials: tip rows, or the up sweep's
// workspace tile; a down step also its outside partial, already pushed
// through its own edge), then the warps run their output panels
// (big_panels), every matrix streamed in 16 x 16 pieces:
//
// * up step i: y = (P_0 x_0) * (P_1 x_1), rescaled over all NSp states
//   of each column, into the workspace ws_clv[i] (row NSp the log2
//   scale); the root's computes nothing;
// * down step i (root first): q_k = P_k x_k; the children's outside
//   partials o_0 = g * q_1, o_1 = g * q_0 (g = pi at the root, else node
//   i's pushed outside partial from ws_out[i]), each rescaled; then for
//   each child u = r_k the products V^T o_k (V streamed transposed) and
//   V^-1 x_k, whose product d[u] goes to device memory from the
//   registers, and for an internal child P_u^T o_k, the outside partial
//   its own down step starts from, into ws_out[u] (a walk of its own:
//   one walk of all three products held 171 registers a thread, one
//   block of 5 warps an SM at 80 states).
//
// Shared memory (big_edotp_smem, floats): the warps' rings W x 2 x 2 x
// 256, the two children's tiles 2 x (NSp + 1) x 16, the outside partial
// (NSp + 1) x 16, the two outside partials o_k 2 x NSp x 16 and the
// column maxima 2 x W x 16: 56 KB at 80 states (W = 5), 92 KB at 160.
// The workspace is [n_int, C, NSp + 1, Pw] twice, as edotp.cuh's.  Each
// block checks the child table once and traps on a child outside
// [0, n_otu + i) in row i.
#include "big_ffma.cuh"

namespace phyml {

__global__ void __launch_bounds__(32 * kFfmaMaxWarps)
    big_edotp_kernel(const int* __restrict__ child,
                     const float* __restrict__ tips,
                     const float* __restrict__ pmats,
                     const float* __restrict__ V,
                     const float* __restrict__ Vinv,
                     const float* __restrict__ pi, float* __restrict__ d,
                     float* __restrict__ scd, float* __restrict__ ws_clv,
                     float* __restrict__ ws_out, int n_otu, int n_int,
                     int NSp, int P, int Pw) {
  constexpr int T = kFfmaTile;
  const size_t M = static_cast<size_t>(NSp) * NSp;
  {
    // my tree (grid.z) of a stack: its operands at 64-bit base offsets
    const size_t z = blockIdx.z, n_nodes = n_otu + n_int, C = gridDim.y;
    child += z * 2 * n_int;
    pmats += z * n_nodes * C * M;
    d += z * n_nodes * C * NSp * P;
    scd += z * n_nodes * C * P;
    ws_clv += z * n_int * C * (NSp + 1) * Pw;
    ws_out += z * n_int * C * (NSp + 1) * Pw;
  }
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x, wy = threadIdx.y, W = blockDim.y;
  const int tid = wy * 32 + lane, nthr = 32 * W;
  const int C = gridDim.y, c = blockIdx.y, p0 = blockIdx.x * T;
  const int n_nodes = n_otu + n_int, kTile = (NSp + 1) * T;
  const size_t sP = P, sW = Pw;
  float* ring = smem + wy * 2 * 2 * kFfmaPiece;  // my warp's
  float* xt = smem + W * 2 * 2 * kFfmaPiece;     // [2][NSp+1][T]
  float* gt = xt + 2 * kTile;                   // [NSp+1][T]
  float* ob = gt + kTile;                       // [2][NSp][T]
  float* colmax = ob + 2 * NSp * T;             // [2][W][T]
  {
    bool bad = false;
    for (int i = tid; i < n_int; i += nthr)
      bad |= static_cast<unsigned>(child[2 * i]) >=
                 static_cast<unsigned>(n_otu + i) ||
             static_cast<unsigned>(child[2 * i + 1]) >=
                 static_cast<unsigned>(n_otu + i);
    if (__syncthreads_or(bad)) __trap();
  }
  // the root row is meaningless: zeros
  {
    const size_t root = n_nodes - 1;
    for (int e = tid; e < kTile; e += nthr) {
      const int r = e / T, p = p0 + e % T;
      if (p >= P) continue;
      if (r < NSp)
        d[((root * C + c) * NSp + r) * sP + p] = 0.0f;
      else
        scd[(root * C + c) * sP + p] = 0.0f;
    }
  }
  const float* Vc = V + c * M;
  const float* Vic = Vinv + c * M;
  const float* pi_c = pi + static_cast<size_t>(c) * NSp;
  // a node's tile of my class in a workspace: rows lie sW apart
  const size_t ws_node = static_cast<size_t>(C) * (NSp + 1) * sW;
  auto ws_tile = [&](float* ws, int idx) {
    return ws + idx * ws_node + static_cast<size_t>(c) * (NSp + 1) * sW + p0;
  };
  auto pm_of = [&](int u) {
    return pmats + (static_cast<size_t>(u) * C + c) * M;
  };
  // a workspace tile (NSp + 1 rows of 16 floats) into shared memory
  auto copy_tile = [&](float* dst, const float* src) {
    for (int q = tid; q < (NSp + 1) * 4; q += nthr) {
      const int r = q >> 2, c4 = q & 3;
      cp_async16(dst + r * T + 4 * c4, src + r * sW + 4 * c4);
    }
  };
  // child u's partial (tip rows and a zero scale row, or its tile of
  // the up sweep's workspace) into xt[k]
  auto fetch_x = [&](int k, int u) {
    float* dst = xt + k * kTile;
    if (u < n_otu) {
      big_copy_tip(dst, tips + static_cast<size_t>(u) * NSp * sP, NSp, p0,
                   P, sP, tid, nthr);
      for (int l = tid; l < T; l += nthr) dst[NSp * T + l] = 0.0f;
    } else {
      copy_tile(dst, ws_tile(ws_clv, u - n_otu));
    }
  };
  // the thread's column in the rescales, and its first row
  const int j = tid % T, r0 = tid / T, rstep = nthr / T;
  const int rg = lane >> 3, pg = lane & 7;

  for (int i = 0; i < n_int - 1; ++i) {  // up sweep; the root's is unused
    const int u0 = child[2 * i], u1 = child[2 * i + 1];
    __syncthreads();  // the last step is done with xt and ob
    fetch_x(0, u0);
    fetch_x(1, u1);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const float* m[2] = {pm_of(u0), pm_of(u1)};
    const float* x[2] = {xt, xt + kTile};
    float cm[2] = {0.0f, 0.0f};
    big_panels<2, 0u>(ring, m, x, NSp, wy, W,
                      [&](int o, float (&acc)[2][4][2]) {
                        float y[4][2];
#pragma unroll
                        for (int a = 0; a < 4; ++a)
#pragma unroll
                          for (int q = 0; q < 2; ++q)
                            y[a][q] = acc[0][a][q] * acc[1][a][q];
                        big_store_tile(ob, o, y, cm);
                      });
    big_warp_colmax(cm, colmax, wy);
    float s = xt[NSp * T + j] + xt[kTile + NSp * T + j];
    __syncthreads();  // ob and colmax whole
    const float f = big_column_factor(colmax, W, j, &s);
    float* dst = ws_tile(ws_clv, i);
    for (int r = r0; r < NSp; r += rstep) dst[r * sW + j] = ob[r * T + j] * f;
    if (r0 == 0) dst[NSp * sW + j] = s;
  }

  for (int i = n_int - 1; i >= 0; --i) {  // down sweep, root first
    const int u[2] = {child[2 * i], child[2 * i + 1]};
    __syncthreads();  // the last step is done with xt, gt and ob
    fetch_x(0, u[0]);
    fetch_x(1, u[1]);
    if (i < n_int - 1) {
      copy_tile(gt, ws_tile(ws_out, i));
    } else {
      for (int e = tid; e < kTile; e += nthr)
        gt[e] = e < NSp * T ? pi_c[e / T] : 0.0f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // the children's outside partials o_k = g * q_(1-k), unscaled
    {
      const float* m[2] = {pm_of(u[0]), pm_of(u[1])};
      const float* x[2] = {xt, xt + kTile};
      float cm0[2] = {0.0f, 0.0f}, cm1[2] = {0.0f, 0.0f};
      big_panels<2, 0u>(
          ring, m, x, NSp, wy, W, [&](int o, float (&acc)[2][4][2]) {
            const float* g = gt + (o * kBigPanel + 4 * rg) * T + 2 * pg;
            float o0[4][2], o1[4][2];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const float2 gv = *reinterpret_cast<const float2*>(g + a * T);
              o0[a][0] = gv.x * acc[1][a][0], o0[a][1] = gv.y * acc[1][a][1];
              o1[a][0] = gv.x * acc[0][a][0], o1[a][1] = gv.y * acc[0][a][1];
            }
            big_store_tile(ob, o, o0, cm0);
            big_store_tile(ob + NSp * T, o, o1, cm1);
          });
      big_warp_colmax(cm0, colmax, wy);
      big_warp_colmax(cm1, colmax + W * T, wy);
    }
    const float sg = gt[NSp * T + j];
    const float sx[2] = {xt[NSp * T + j], xt[kTile + NSp * T + j]};
    __syncthreads();  // ob and colmax whole
    // each o_k rescaled over its column; its scales into sc_d and, for
    // an internal child, the scale row of its pushed outside partial
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      float sco = sg + sx[1 - k];
      const float f = big_column_factor(colmax + k * W * T, W, j, &sco);
      float* ok = ob + k * NSp * T;
      for (int r = r0; r < NSp; r += rstep) ok[r * T + j] *= f;
      if (r0 == 0) {
        if (p0 + j < P)
          scd[(static_cast<size_t>(u[k]) * C + c) * sP + p0 + j] =
              (sco + sx[k]) * kLn2;
        if (u[k] >= n_otu) ws_tile(ws_out, u[k] - n_otu)[NSp * sW + j] = sco;
      }
    }
    __syncthreads();  // o_0 and o_1 rescaled
#pragma unroll 1
    for (int k = 0; k < 2; ++k) {
      const float* ok = ob + k * NSp * T;
      const float* x = xt + k * kTile;
      float* d_u = d + (static_cast<size_t>(u[k]) * C + c) * NSp * sP + p0 +
                   2 * pg;
      {
        // d[u] = (V^T o_k) * (V^-1 x_k): V streamed transposed (bit 0)
        const float* m[2] = {Vc, Vic};
        const float* xs[2] = {ok, x};
        big_panels<2, 1u>(
            ring, m, xs, NSp, wy, W, [&](int o, float (&acc)[2][4][2]) {
#pragma unroll
              for (int a = 0; a < 4; ++a) {
                const size_t row = o * kBigPanel + 4 * rg + a;
#pragma unroll
                for (int q = 0; q < 2; ++q)
                  if (p0 + 2 * pg + q < P)
                    d_u[row * sP + q] = acc[0][a][q] * acc[1][a][q];
              }
            });
      }
      if (u[k] >= n_otu) {
        // an internal child's outside partial pushed through its own
        // edge, P_u^T o_k, which its own down step starts from
        const float* m[1] = {pm_of(u[k])};
        const float* xs[1] = {ok};
        float* h_u = ws_tile(ws_out, u[k] - n_otu) + 2 * pg;
        big_panels<1, 1u>(
            ring, m, xs, NSp, wy, W, [&](int o, float (&acc)[1][4][2]) {
#pragma unroll
              for (int a = 0; a < 4; ++a) {
                const size_t row = o * kBigPanel + 4 * rg + a;
                *reinterpret_cast<float2*>(h_u + row * sW) =
                    make_float2(acc[0][a][0], acc[0][a][1]);
              }
            });
      }
    }
  }
  cp_async_wait<0>();
}

// bytes of shared memory of one block (the layout of big_edotp_kernel)
size_t big_edotp_smem(int NSp) {
  const size_t W = ffma_warps(NSp), T = kFfmaTile;
  return (W * 2 * 2 * kFfmaPiece + 3 * (NSp + 1) * T + 2 * NSp * T +
          2 * W * T) *
         sizeof(float);
}

int big_edotp_launch(const int* child, const float* tips,
                     const float* pmats, const float* V, const float* Vinv,
                     const float* pi, float* d, float* scd, float* ws_clv,
                     float* ws_out, int n_otu, int n_int, int NSp, int C,
                     int P, int Pw, int R, cudaStream_t stream) {
  const size_t smem = big_edotp_smem(NSp);
  if (!big_width(NSp) || Pw % kFfmaTile != 0 || Pw < P ||
      Pw - P >= kFfmaTile || smem > kMaxSmem)
    return kUnsupported;
  cudaError_t err = allow_smem(big_edotp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(32, ffma_warps(NSp)), grid(Pw / kFfmaTile, C, R);
  big_edotp_kernel<<<grid, block, smem, stream>>>(
      child, tips, pmats, V, Vinv, pi, d, scd, ws_clv, ws_out, n_otu, n_int,
      NSp, P, Pw);
  return static_cast<int>(cudaGetLastError());
}

int big_edotp_occupancy(int NSp, int* blocks_per_sm) {
  const size_t smem = big_edotp_smem(NSp);
  if (!big_width(NSp) || smem > kMaxSmem) return kUnsupported;
  cudaError_t err = allow_smem(big_edotp_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, big_edotp_kernel, 32 * ffma_warps(NSp), smem));
}

}  // namespace phyml
