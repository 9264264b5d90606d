// K5: the edge dot products on the streamed route.
//
// Replaces phyml_tpu/ops/pallas_edotp.py:_edotp_stream_kernel (wrapper
// edge_dotprods_pallas_stream).  The kernel body, its design and what
// bounds it are in edotp.cuh, shared with K2 (edotp.cu): each step's
// two child P-matrices (ns^2 floats of the block's class, 1.6 KB at
// ns = 20) travel with its partials in the cp.async ring, which a
// 128-taxon protein tree needs, its 1.6 MB of P-matrices missing L1
// (ops/likelihood.py:kernel_route).
#include "edotp.cuh"

namespace phyml {

template <int NS>
__global__ void edge_dotprods_stream_kernel(
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

#define PHYML_EDOTP_KERNEL phyml::edge_dotprods_stream_kernel
PHYML_EDOTP_ENTRY(phyml_edge_dotprods_stream)
