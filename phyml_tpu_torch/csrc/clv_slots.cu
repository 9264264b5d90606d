// K1: the slot-scheduled Felsenstein pass for one parameter set, on the
// resident route.
//
// Replaces phyml_tpu/ops/pallas_clv_slots.py:_slot_kernel (wrapper
// uppass_site_lse_slots).  The kernel body, its design and what bounds
// it are in slots.cuh, shared with K4 (clv_slots_stream.cu).  Here each
// warp holds its class's P-matrices for the whole tree in shared memory,
// copied once at block start: the route of trees whose matrices fit a
// warp's share of shared memory (ops/likelihood.py:kernel_route), under its own
// name so that profiles and launch counts tell the routes apart.
#include "slots.cuh"

namespace phyml {

template <int NS>
__global__ void slot_site_lse_kernel(
    const int* __restrict__ sched, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ pi,
    const float* __restrict__ logw,
    float* __restrict__ out, int n_otu, int n_int, int n_slots, int P,
    int ldt) {
  slot_site_lse_body<NS, true>(sched, tips, pmats, pi, logw, out, n_otu,
                               n_int, n_slots, P, ldt);
}

}  // namespace phyml

PHYML_SLOT_ENTRY(phyml_slot_site_lse, phyml::slot_site_lse_kernel, true)
