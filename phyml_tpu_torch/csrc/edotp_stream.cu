// K5: up sweep + outside sweep + per-edge eigen-basis dot products,
// with the P-matrices and tip rows streamed through a shared-memory
// ring.
//
// Replaces phyml_tpu/ops/pallas_edotp.py:_edotp_stream_kernel (wrapper
// edge_dotprods_pallas_stream).  It computes K2's function (edotp.cu):
// for every edge u
//     d[u]    = (V^T O_u) * (V^-1 C_u)        [C, ns, P]
//     sc_d[u] = (sc_out[u] + sc[u]) * ln 2    [C, P]
// from one postorder sweep (rescaled internal partials C_u) and one
// reverse sweep (outside partials O_u, d/sc_d written per node); the
// root row is zeroed.  The internal partials and outside partials stay
// in a global workspace [n_int, C, ns, Pw], as in K2: at 128 taxa they
// are ~21 KB per (pattern, class) at ns = 20, far past shared memory.
//
// What differs from K2 is where a step's operands come from.  The
// block copies step i+1's P-matrices (child 0, child 1 and, in the
// outside sweep, the parent's: C*ns^2 floats each, 6.4 KB at ns = 20,
// C = 4) and its tip rows into one half of a double-buffered ring with
// cp.async while step i computes from the other half, so every matvec
// reads its matrix from shared memory as a warp-wide broadcast instead
// of a dependent L1/L2 load; V and V^-1, used by every d row, are
// staged once.  d/sc_d rows are stored per node straight from
// registers.
//
// What bounds it on the H100: at 128 x 4096 amino acids, C = 4, about
// 11 GFLOP of matvecs (0.17 ms at the FP32 peak) and 320 MB of d
// written once (0.10 ms at the HBM rate), so bound by operations; the
// workspace traffic (written and read once per sweep) comes on top.
#include "common.cuh"

namespace phyml {

template <int NS>
__global__ void edge_dotprods_stream_kernel(
    const int* __restrict__ child, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ V,
    const float* __restrict__ Vinv, const float* __restrict__ pi,
    float* __restrict__ d, float* __restrict__ scd,
    float* __restrict__ ws_clv, float* __restrict__ ws_sc,
    float* __restrict__ ws_out, float* __restrict__ ws_sco, int n_otu,
    int n_int, int P, int Pw) {
  extern __shared__ __align__(16) float smem[];
  const int tp = blockDim.x, C = blockDim.y;
  const int lp = threadIdx.x, c = threadIdx.y;
  const int tid = c * tp + lp, nthr = tp * C;
  const int p0 = blockIdx.x * tp;
  const int p = p0 + lp;
  const bool live = p < P;
  const size_t sP = P, sW = Pw;
  const int mat = C * NS * NS;  // floats of one node's P-matrices
  // ring: pm_ring[stage][child 0, child 1, parent][mat],
  // tip_ring[stage][child][NS][tp]; then V and V^-1, [mat] each
  float* pm_ring = smem;
  float* tip_ring = pm_ring + 6 * mat;
  float* Vs = tip_ring + 4 * NS * tp;
  float* Vis = Vs + mat;

  auto wvec = [&](float* base, int i) {  // [n_int, C, NS, Pw] column
    return base + (static_cast<size_t>(i) * C + c) * NS * sW + p;
  };
  auto wsc = [&](float* base, int i) -> float& {  // [n_int, C, Pw]
    return base[(static_cast<size_t>(i) * C + c) * sW + p];
  };
  // issue the copies of step i's operands into ring half `stage`
  auto fetch = [&](int i, int stage, bool parent) {
    const int cid[2] = {child[2 * i], child[2 * i + 1]};
    float* ring = pm_ring + 3 * stage * mat;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      copy_block16(ring + k * mat, pmats + static_cast<size_t>(cid[k]) * mat,
                   mat, tid, nthr);
      if (cid[k] < n_otu)
        copy_tip_rows<NS>(tip_ring + (2 * stage + k) * NS * tp,
                          tips + static_cast<size_t>(cid[k]) * NS * P, p0, P,
                          tp, tid, nthr);
    }
    if (parent && i < n_int - 1)  // the root row has no parent edge
      copy_block16(ring + 2 * mat,
                   pmats + static_cast<size_t>(n_otu + i) * mat, mat, tid,
                   nthr);
    cp_async_commit();
  };
  // rescaled partial of child k (node `node`) of the step in `stage`
  auto node_clv = [&](int node, int stage, int k, float(&v)[NS], float& s) {
    if (node < n_otu) {
      const float* t = tip_ring + (2 * stage + k) * NS * tp + lp;
#pragma unroll
      for (int j = 0; j < NS; ++j) v[j] = t[j * tp];
      s = 0.0f;
    } else {
      load_col<NS>(wvec(ws_clv, node - n_otu), sW, v);
      s = wsc(ws_sc, node - n_otu);
    }
  };
  // wait for step i's copies (the next step's are in flight), compute
  // it with body(stage), free the ring half
  auto pipelined = [&](int i_next, bool has_next, int stage, bool parent,
                       auto body) {
    if (has_next)
      fetch(i_next, stage ^ 1, parent);
    else
      cp_async_commit();  // empty group: keeps the wait below uniform
    cp_async_wait<1>();
    __syncthreads();
    body();
    __syncthreads();  // ring half `stage` is free for the step after next
  };

  // V and V^-1 travel with the first step's group
  copy_block16(Vs, V, mat, tid, nthr);
  copy_block16(Vis, Vinv, mat, tid, nthr);

  // ---- up sweep: internal rescaled partials ------------------------
  fetch(0, 0, false);
  for (int i = 0; i < n_int; ++i) {
    const int stage = i & 1;
    pipelined(i + 1, i + 1 < n_int, stage, false, [&] {
      const float* ring = pm_ring + 3 * stage * mat + c * NS * NS;
      float x[NS], s0, s1;
      {
        float v[NS];
        node_clv(child[2 * i], stage, 0, v, s0);
        matvec<NS>(ring, v, x);
      }
      {
        float v[NS], y[NS];
        node_clv(child[2 * i + 1], stage, 1, v, s1);
        matvec<NS>(ring + mat, v, y);
#pragma unroll
        for (int j = 0; j < NS; ++j) x[j] *= y[j];
      }
      const float e = rescale<NS>(x);
      store_col<NS>(wvec(ws_clv, i), sW, x);
      wsc(ws_sc, i) = s0 + s1 + e;
    });
  }

  // ---- down sweep: outside partials, d and sc_d per node -----------
  // d/sc_d of child k of the step in `stage` from its outside partial
  // o; as in K2 (kHoldPartials), at ns = 4 from its held partial x and
  // whole vectors, at ns = 20 from its partial loaded again, row by row
  const float* Vc = Vs + c * NS * NS;
  const float* Vic = Vis + c * NS * NS;
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
  auto emit_reload = [&](int node, int stage, int k, const float(&o)[NS],
                         float sco) {
    // loaded before the ragged-edge test: the other order spilled
    // 2.8 KB at ns = 20 (ptxas)
    float x[NS], sx;
    node_clv(node, stage, k, x, sx);
    if (!live) return;
    eigen_dot_rows<NS>(Vc, Vic, o, x, d_col(node), sP);
    sc_d(node) = (sco + sx) * kLn2;
  };
  fetch(n_int - 1, 0, true);
  for (int k = 0; k < n_int; ++k) {  // root row first
    const int i = n_int - 1 - k, stage = k & 1;
    pipelined(i - 1, k + 1 < n_int, stage, true, [&] {
      const float* ring = pm_ring + 3 * stage * mat + c * NS * NS;
      const int c0 = child[2 * i], c1 = child[2 * i + 1];
      float x0[NS], x1[NS], q0[NS], q1[NS], s0, s1;
      if constexpr (kHoldPartials<NS>) {
        node_clv(c0, stage, 0, x0, s0);
        node_clv(c1, stage, 1, x1, s1);
        matvec<NS>(ring, x0, q0);
        matvec<NS>(ring + mat, x1, q1);
      } else {  // one partial live at a time
        node_clv(c0, stage, 0, x0, s0);
        matvec<NS>(ring, x0, q0);
        node_clv(c1, stage, 1, x0, s1);
        matvec<NS>(ring + mat, x0, q1);
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
        matvec_t<NS>(ring + 2 * mat, o, g);
      }
      // outside partials of the children: o0 = g * q1 (into q1) and
      // o1 = g * q0 (into q0)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        q1[j] *= g[j];
        q0[j] *= g[j];
      }
      const float sco0 = sg + s1 + rescale<NS>(q1);
      const float sco1 = sg + s0 + rescale<NS>(q0);
      if (c0 >= n_otu) {
        store_col<NS>(wvec(ws_out, c0 - n_otu), sW, q1);
        wsc(ws_sco, c0 - n_otu) = sco0;
      }
      if (c1 >= n_otu) {
        store_col<NS>(wvec(ws_out, c1 - n_otu), sW, q0);
        wsc(ws_sco, c1 - n_otu) = sco1;
      }
      if constexpr (kHoldPartials<NS>) {
        emit_held(c0, q1, sco0, x0, s0);
        emit_held(c1, q0, sco1, x1, s1);
      } else {
        emit_reload(c0, stage, 0, q1, sco0);
        emit_reload(c1, stage, 1, q0, sco1);
      }
    });
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
int launch_edotp_stream(const int* child, const float* tips,
                        const float* pmats, const float* V, const float* Vinv,
                        const float* pi, float* d, float* scd, float* ws_clv,
                        float* ws_sc, float* ws_out, float* ws_sco, int n_otu,
                        int n_int, int C, int P, int Pw, int tp,
                        cudaStream_t stream) {
  const size_t smem =
      (8 * static_cast<size_t>(C) * NS * NS + 4 * NS * tp) * sizeof(float);
  if (smem > kMaxSmem) return kUnsupported;
  cudaError_t err = allow_smem(edge_dotprods_stream_kernel<NS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(tp, C), grid(Pw / tp);
  edge_dotprods_stream_kernel<NS><<<grid, block, smem, stream>>>(
      child, tips, pmats, V, Vinv, pi, d, scd, ws_clv, ws_sc, ws_out, ws_sco,
      n_otu, n_int, P, Pw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace phyml

extern "C" int phyml_edge_dotprods_stream(
    const int* child, const float* tips, const float* pmats, const float* V,
    const float* Vinv, const float* pi, float* d, float* scd, float* ws_clv,
    float* ws_sc, float* ws_out, float* ws_sco, int n_otu, int n_int, int ns,
    int C, int P, int Pw, int tp, void* stream) {
  if (tp * C > 1024 || Pw % tp != 0) return phyml::kUnsupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 4:
      return phyml::launch_edotp_stream<4>(child, tips, pmats, V, Vinv, pi, d,
                                           scd, ws_clv, ws_sc, ws_out, ws_sco,
                                           n_otu, n_int, C, P, Pw, tp, st);
    case 20:
      return phyml::launch_edotp_stream<20>(child, tips, pmats, V, Vinv, pi,
                                            d, scd, ws_clv, ws_sc, ws_out,
                                            ws_sco, n_otu, n_int, C, P, Pw, tp,
                                            st);
    default:
      return phyml::kUnsupported;
  }
}
