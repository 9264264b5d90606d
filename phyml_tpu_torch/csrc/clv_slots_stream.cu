// K4: the slot-scheduled Felsenstein pass for one parameter set, on the
// streamed route.
//
// Replaces phyml_tpu/ops/pallas_clv_slots.py:_slot_stream_kernel
// (wrapper uppass_site_lse_slots_stream).  The kernel body, its design
// and what bounds it are in slots.cuh, shared with K1 (clv_slots.cu).
// Here each step's two child P-matrices stream through a per-warp
// cp.async ring with the step's tip rows: the route of trees whose
// matrices do not fit a warp's share of shared memory (128-taxon
// protein: 408 KB a class; ops/likelihood.py:kernel_route).
#include "slots.cuh"

namespace phyml {

template <int NS>
__global__ void slot_site_lse_stream_kernel(
    const int* __restrict__ sched, const float* __restrict__ tips,
    const float* __restrict__ pmats, const float* __restrict__ pi,
    const float* __restrict__ logw,
    float* __restrict__ out, int n_otu, int n_int, int n_slots, int C,
    int P, int ldt) {
  slot_site_lse_body<NS, false>(sched, tips, pmats, pi, logw, out, n_otu,
                                n_int, n_slots, C, P, ldt);
}

}  // namespace phyml

#define PHYML_SLOT_KERNEL phyml::slot_site_lse_stream_kernel
#define PHYML_SLOT_RESIDENT false
PHYML_SLOT_ENTRY(phyml_slot_site_lse_stream)
