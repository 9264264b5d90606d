// K2: the edge dot products on the resident route.
//
// Replaces phyml_tpu/ops/pallas_edotp.py:_edotp_kernel (wrapper
// edge_dotprods_pallas).  The kernel body, its design and what bounds
// it are in edotp.cuh, shared with K5 (edotp_stream.cu): it serves the
// trees whose P-matrices stay close to one SM
// (ops/likelihood.py:kernel_route: 128-taxon DNA, 65 KB), under its own
// name so that profiles and launch counts tell the routes apart.
#include "edotp.cuh"

namespace phyml {

template <int NS>
__global__ void edge_dotprods_kernel(
    const int* __restrict__ child, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ V,
    const float* __restrict__ Vinv, const float* __restrict__ pi,
    float* __restrict__ d, float* __restrict__ scd,
    float* __restrict__ ws_clv, float* __restrict__ ws_out, int n_otu,
    int n_int, int P, int Pw) {
  edge_dotprods_body<NS>(child, tips, pmats, V, Vinv, pi, d, scd,
                                ws_clv, ws_out, n_otu, n_int, P, Pw);
}

}  // namespace phyml

PHYML_EDOTP_ENTRY(phyml_edge_dotprods, phyml::edge_dotprods_kernel)
