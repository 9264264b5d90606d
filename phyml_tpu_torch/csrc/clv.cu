// K3: child-table Felsenstein pass, variable-rate site lnL, batched
// over parameter sets.
//
// Replaces phyml_tpu/ops/pallas_clv.py:_uppass_kernel (wrapper
// uppass_site_lse), and with its leading batch dimension the vmap of
// that kernel in the parameter line search.  It walks the postorder
// child table; each internal node combines its children's pushed
// partials, rescales, and pushes the result through its own edge's
// P-matrix.  Tips are pushed on the fly at their parent, so only the
// internal nodes' pushed partials need scratch: they cannot fit in
// shared memory for a useful block (~8 KB per (pattern, class) at 128
// taxa), so they live in a global workspace [B, n_int, C, ns, Pw]
// that the wrapper allocates.
//
// What bounds it on the H100: global-memory bytes for that workspace
// (written once and read once per internal node) plus the tip reads;
// the FLOPs are ~2*ns^2 per child.  The layout puts the pattern axis
// last, so a warp's loads and stores are coalesced, and every thread
// of a warp reads the same P-matrix entry (an L1 broadcast).  The
// batch is the grid's y dimension.  The workspace grows with ns: at
// amino acids (ns = 20), 128 taxa, C = 4, ~4096 patterns and the
// line search's B = 13 it is 13*127*4*20*4096*4 B, about 2.2 GB, which
// the 80 GB card holds easily.
#include "common.cuh"

namespace phyml {

template <int NS>
__global__ void dense_site_lse_kernel(
    const int* __restrict__ child, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ pi,
    const float* __restrict__ logw, float* __restrict__ out,
    float* __restrict__ ws_pup, float* __restrict__ ws_sc, int n_otu,
    int n_int, int P, int Pw) {
  extern __shared__ float red[];  // [C][tp] root class terms
  const int tp = blockDim.x, C = blockDim.y;
  const int lp = threadIdx.x, c = threadIdx.y, b = blockIdx.y;
  const int p = blockIdx.x * tp + lp;
  const int col = p < P ? p : P - 1;  // ragged edge: valid tip reads only
  const int n_nodes = n_otu + n_int;
  const size_t sP = P, sW = Pw;
  const float* pm = pmats + static_cast<size_t>(b) * n_nodes * C * NS * NS;
  float* pup = ws_pup + static_cast<size_t>(b) * n_int * C * NS * sW;
  float* scs = ws_sc + static_cast<size_t>(b) * n_int * C * sW;

  // pushed partial P(t_node) @ clv_node and its log2 scale
  auto pushed = [&](int node, float(&v)[NS], float& s) {
    if (node < n_otu) {
      float t[NS];
      load_col<NS>(tips + static_cast<size_t>(node) * NS * sP + col, sP, t);
      matvec<NS>(pm + (static_cast<size_t>(node) * C + c) * NS * NS, t, v);
      s = 0.0f;
    } else {
      const size_t i = node - n_otu;
      load_col<NS>(pup + (i * C + c) * NS * sW + p, sW, v);
      s = scs[(i * C + c) * sW + p];
    }
  };

  for (int i = 0; i < n_int - 1; ++i) {
    float v0[NS], v1[NS], s0, s1;
    pushed(child[2 * i], v0, s0);
    pushed(child[2 * i + 1], v1, s1);
    float x[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) x[j] = v0[j] * v1[j];
    const float e = rescale<NS>(x);
    float y[NS];
    matvec<NS>(pm + (static_cast<size_t>(n_otu + i) * C + c) * NS * NS, x, y);
    store_col<NS>(pup + (static_cast<size_t>(i) * C + c) * NS * sW + p, sW, y);
    scs[(static_cast<size_t>(i) * C + c) * sW + p] = s0 + s1 + e;
  }

  // root row: not pushed; sum_x pi * clv, log-sum-exp over classes
  float v0[NS], v1[NS], s0, s1;
  pushed(child[2 * (n_int - 1)], v0, s0);
  pushed(child[2 * (n_int - 1) + 1], v1, s1);
  const float* pi_b = pi + static_cast<size_t>(b) * C * NS;
  float l = 0.0f;
#pragma unroll
  for (int x = 0; x < NS; ++x) l += pi_b[c * NS + x] * (v0[x] * v1[x]);
  l = fmaxf(l, FLT_MIN);
  red[c * tp + lp] = logw[b * C + c] + (s0 + s1) * kLn2 + logf(l);
  __syncthreads();
  if (c == 0 && p < P) out[static_cast<size_t>(b) * P + p] = class_lse(red + lp, C, tp);
}

template <int NS>
int launch_dense(const int* child, const float* tips, const float* pmats,
                 const float* pi, const float* logw, float* out, float* ws_pup,
                 float* ws_sc, int n_otu, int n_int, int C, int P, int Pw,
                 int B, int tp, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tp) * C * sizeof(float);
  const dim3 block(tp, C), grid(Pw / tp, B);
  dense_site_lse_kernel<NS><<<grid, block, smem, stream>>>(
      child, tips, pmats, pi, logw, out, ws_pup, ws_sc, n_otu, n_int, P, Pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace phyml

extern "C" int phyml_dense_site_lse(const int* child, const float* tips,
                                    const float* pmats, const float* pi,
                                    const float* logw, float* out,
                                    float* ws_pup, float* ws_sc, int n_otu,
                                    int n_int, int ns, int C, int P, int Pw,
                                    int B, int tp, void* stream) {
  if (tp * C > 1024 || Pw % tp != 0 || B > 65535)
    return phyml::kUnsupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 4:
      return phyml::launch_dense<4>(child, tips, pmats, pi, logw, out, ws_pup,
                                    ws_sc, n_otu, n_int, C, P, Pw, B, tp, st);
    case 20:
      return phyml::launch_dense<20>(child, tips, pmats, pi, logw, out,
                                     ws_pup, ws_sc, n_otu, n_int, C, P, Pw, B,
                                     tp, st);
    default:
      return phyml::kUnsupported;
  }
}
