// K2: up sweep + outside sweep + per-edge eigen-basis dot products.
//
// Replaces phyml_tpu/ops/pallas_edotp.py:_edotp_kernel (wrapper
// edge_dotprods_pallas).  For every edge u it emits
//     d[u]    = (V^T O_u) * (V^-1 C_u)        [C, ns, P]
//     sc_d[u] = (sc_out[u] + sc[u]) * ln 2    [C, P]
// which the branch-length Newton turns into lnL(t) and its
// derivatives for every edge at once.  One postorder sweep stores the
// rescaled internal partials C_u; a reverse sweep builds the outside
// partials O_u and writes d/sc_d per node.  The root row is zeroed;
// the zero-length root child's row is meaningless (callers mask it).
//
// What bounds it on the H100: global-memory bytes.  The per-pattern
// scratch (clv + outside partials and their scales for every internal
// node, ~5 KB per (pattern, class) at 128 taxa) does not fit in
// shared memory, so it lives in a global workspace [n_int, C, ns, Pw]
// that the wrapper allocates, and the d output alone is
// n_nodes * C * ns * P floats.  Threads are (pattern, class) pairs
// with no cross-thread communication; the pattern axis is last in
// every array, so a warp's loads and stores are coalesced, and all
// threads of a warp read the same P-matrix entry (an L1 broadcast).
#include "common.cuh"

namespace phyml {

template <int NS>
__global__ void edge_dotprods_kernel(
    const int* __restrict__ child, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ V,
    const float* __restrict__ Vinv, const float* __restrict__ pi,
    float* __restrict__ d, float* __restrict__ scd,
    float* __restrict__ ws_clv, float* __restrict__ ws_sc,
    float* __restrict__ ws_out, float* __restrict__ ws_sco, int n_otu,
    int n_int, int P, int Pw) {
  const int tp = blockDim.x, C = blockDim.y;
  const int lp = threadIdx.x, c = threadIdx.y;
  const int p = blockIdx.x * tp + lp;
  const bool live = p < P;
  const int col = live ? p : P - 1;  // ragged edge: valid tip reads only
  const size_t sP = P, sW = Pw;
  auto pm = [&](int node) {
    return pmats + (static_cast<size_t>(node) * C + c) * NS * NS;
  };
  auto wvec = [&](float* base, int i) {  // [n_int, C, NS, Pw] column
    return base + (static_cast<size_t>(i) * C + c) * NS * sW + p;
  };
  auto wsc = [&](float* base, int i) -> float& {  // [n_int, C, Pw]
    return base[(static_cast<size_t>(i) * C + c) * sW + p];
  };
  // rescaled partial of `node` below its edge, and its log2 scale
  auto node_clv = [&](int node, float(&v)[NS], float& s) {
    if (node < n_otu) {
      load_col<NS>(tips + static_cast<size_t>(node) * NS * sP + col, sP, v);
      s = 0.0f;
    } else {
      load_col<NS>(wvec(ws_clv, node - n_otu), sW, v);
      s = wsc(ws_sc, node - n_otu);
    }
  };

  // ---- up sweep: internal rescaled partials ------------------------
  for (int i = 0; i < n_int; ++i) {
    const int c0 = child[2 * i], c1 = child[2 * i + 1];
    float x0[NS], x1[NS], p0[NS], p1[NS], s0, s1;
    node_clv(c0, x0, s0);
    node_clv(c1, x1, s1);
    matvec<NS>(pm(c0), x0, p0);
    matvec<NS>(pm(c1), x1, p1);
    float x[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) x[j] = p0[j] * p1[j];
    const float e = rescale<NS>(x);
    store_col<NS>(wvec(ws_clv, i), sW, x);
    wsc(ws_sc, i) = s0 + s1 + e;
  }

  // ---- down sweep: outside partials, d and sc_d per node -----------
  // At ns = 4 a step holds both children's partials and forms whole
  // V^T O and V^-1 C vectors for each d.  At ns = 20 that spilled (255
  // registers, 2.6 KB of spill stores a thread, and K5 2.3x slower on
  // an H100), so there a child's partial is loaded again for its d, and
  // each d row is stored as soon as its two dot products are formed:
  // 168 registers, no spill.  kHoldPartials picks the form at compile
  // time; both take the same sums in the same order.
  const float* Vc = V + c * NS * NS;
  const float* Vic = Vinv + c * NS * NS;
  auto d_col = [&](int node) {
    return d + (static_cast<size_t>(node) * C + c) * NS * sP + p;
  };
  auto sc_d = [&](int node) -> float& {
    return scd[(static_cast<size_t>(node) * C + c) * sP + p];
  };
  auto emit_held = [&](int node, const float(&o)[NS], float sco,
                       const float(&x)[NS], float sx) {
    float a[NS], bb[NS];
    matvec_t<NS>(Vc, o, a);
    matvec<NS>(Vic, x, bb);
    if (!live) return;
    float* dn = d_col(node);
#pragma unroll
    for (int j = 0; j < NS; ++j) dn[j * sP] = a[j] * bb[j];
    sc_d(node) = (sco + sx) * kLn2;
  };
  auto emit_reload = [&](int node, const float(&o)[NS], float sco) {
    // loaded before the ragged-edge test: the other order spilled
    // 2.8 KB at ns = 20 (ptxas)
    float x[NS], sx;
    node_clv(node, x, sx);
    if (!live) return;
    eigen_dot_rows<NS>(Vc, Vic, o, x, d_col(node), sP);
    sc_d(node) = (sco + sx) * kLn2;
  };
  for (int i = n_int - 1; i >= 0; --i) {  // root row first
    const int c0 = child[2 * i], c1 = child[2 * i + 1];
    float x0[NS], x1[NS], p0[NS], p1[NS], s0, s1;
    if constexpr (kHoldPartials<NS>) {
      node_clv(c0, x0, s0);
      node_clv(c1, x1, s1);
      matvec<NS>(pm(c0), x0, p0);
      matvec<NS>(pm(c1), x1, p1);
    } else {  // one partial live at a time
      node_clv(c0, x0, s0);
      matvec<NS>(pm(c0), x0, p0);
      node_clv(c1, x0, s1);
      matvec<NS>(pm(c1), x0, p1);
    }
    float g[NS], sg;
    if (i == n_int - 1) {
#pragma unroll
      for (int j = 0; j < NS; ++j) g[j] = pi[c * NS + j];
      sg = 0.0f;
    } else {
      float o[NS];
      load_col<NS>(wvec(ws_out, i), sW, o);
      sg = wsc(ws_sco, i);
      matvec_t<NS>(pm(n_otu + i), o, g);
    }
    // outside partials of the children: o0 = g * p1 (into p1) and
    // o1 = g * p0 (into p0)
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      p1[j] *= g[j];
      p0[j] *= g[j];
    }
    const float sco0 = sg + s1 + rescale<NS>(p1);
    const float sco1 = sg + s0 + rescale<NS>(p0);
    if (c0 >= n_otu) {
      store_col<NS>(wvec(ws_out, c0 - n_otu), sW, p1);
      wsc(ws_sco, c0 - n_otu) = sco0;
    }
    if (c1 >= n_otu) {
      store_col<NS>(wvec(ws_out, c1 - n_otu), sW, p0);
      wsc(ws_sco, c1 - n_otu) = sco1;
    }
    if constexpr (kHoldPartials<NS>) {
      emit_held(c0, p1, sco0, x0, s0);
      emit_held(c1, p0, sco1, x1, s1);
    } else {
      emit_reload(c0, p1, sco0);
      emit_reload(c1, p0, sco1);
    }
  }

  // root row: meaningless, written as zeros
  if (live) {
    const size_t root = n_otu + n_int - 1;
#pragma unroll
    for (int j = 0; j < NS; ++j) d[((root * C + c) * NS + j) * sP + p] = 0.0f;
    scd[(root * C + c) * sP + p] = 0.0f;
  }
}

template <int NS>
int launch_edotp(const int* child, const float* tips, const float* pmats,
                 const float* V, const float* Vinv, const float* pi, float* d,
                 float* scd, float* ws_clv, float* ws_sc, float* ws_out,
                 float* ws_sco, int n_otu, int n_int, int C, int P, int Pw,
                 int tp, cudaStream_t stream) {
  const dim3 block(tp, C), grid(Pw / tp);
  edge_dotprods_kernel<NS><<<grid, block, 0, stream>>>(
      child, tips, pmats, V, Vinv, pi, d, scd, ws_clv, ws_sc, ws_out, ws_sco,
      n_otu, n_int, P, Pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace phyml

extern "C" int phyml_edge_dotprods(const int* child, const float* tips,
                                   const float* pmats, const float* V,
                                   const float* Vinv, const float* pi,
                                   float* d, float* scd, float* ws_clv,
                                   float* ws_sc, float* ws_out, float* ws_sco,
                                   int n_otu, int n_int, int ns, int C, int P,
                                   int Pw, int tp, void* stream) {
  if (tp * C > 1024 || Pw % tp != 0) return phyml::kUnsupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 4:
      return phyml::launch_edotp<4>(child, tips, pmats, V, Vinv, pi, d, scd,
                                    ws_clv, ws_sc, ws_out, ws_sco, n_otu,
                                    n_int, C, P, Pw, tp, st);
    case 20:
      return phyml::launch_edotp<20>(child, tips, pmats, V, Vinv, pi, d, scd,
                                     ws_clv, ws_sc, ws_out, ws_sco, n_otu,
                                     n_int, C, P, Pw, tp, st);
    default:
      return phyml::kUnsupported;
  }
}
