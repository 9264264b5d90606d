// K1: slot-scheduled Felsenstein pass, variable-rate site lnL.
//
// Replaces phyml_tpu/ops/pallas_clv_slots.py:_slot_kernel (wrapper
// uppass_site_lse_slots).  The host builds a Sethi-Ullman schedule
// (build_slot_schedule) whose live set never exceeds
// ceil(log2 n_otu) + 1 partials, so each thread keeps its pattern
// column's partials in n_slots shared-memory slots; only the tips,
// the P-matrices and the schedule are read from global memory, and
// one float per pattern is written.
//
// What bounds it on the H100: global reads of the tip rows (n_otu x
// ns floats per pattern, read once each) and the per-step latency of
// the dependent schedule walk; the matvecs are 2*C*ns^2 FLOPs per
// child.  Every thread of a warp reads the same P-matrix entry (an L1
// broadcast), tip loads are coalesced across the pattern axis, and
// the slot layout [slot][ns+1][thread] keeps shared-memory accesses
// free of bank conflicts.  At ns = 20 the slots take (n_slots*21+1)
// floats per thread, 97 KB for a 128-thread block at 128 taxa.
#include "common.cuh"

namespace phyml {

template <int NS>
__global__ void slot_site_lse_kernel(const int* __restrict__ sched,
                                     const float* __restrict__ tips,
                                     const float* __restrict__ pmats,
                                     const float* __restrict__ pi,
                                     const float* __restrict__ logw,
                                     float* __restrict__ out, int n_int,
                                     int n_slots, int P) {
  extern __shared__ float smem[];
  const int tp = blockDim.x, C = blockDim.y;
  const int lp = threadIdx.x, c = threadIdx.y;
  const int nthr = tp * C;
  const int p = blockIdx.x * tp + lp;
  const int col = p < P ? p : P - 1;  // ragged edge: valid reads only
  const size_t sP = P;
  // this thread's slot entries: slot s, state x at my[(s*(NS+1)+x)*nthr];
  // entry NS holds the slot's log2 scale
  float* my = smem + c * tp + lp;
  float* red = smem + static_cast<size_t>(n_slots) * (NS + 1) * nthr;

  for (int i = 0; i < n_int; ++i) {
    const int* row = sched + 7 * i;
    float v[2][NS];
    float s[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int cid = row[3 * k], is_tip = row[3 * k + 1];
      const int sl = row[3 * k + 2];
      float clv[NS];
      if (is_tip) {
        load_col<NS>(tips + static_cast<size_t>(cid) * NS * sP + col, sP,
                     clv);
        s[k] = 0.0f;
      } else {
#pragma unroll
        for (int x = 0; x < NS; ++x) clv[x] = my[(sl * (NS + 1) + x) * nthr];
        s[k] = my[(sl * (NS + 1) + NS) * nthr];
      }
      matvec<NS>(pmats + (static_cast<size_t>(cid) * C + c) * NS * NS, clv,
                 v[k]);
    }
    float x[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) x[j] = v[0][j] * v[1][j];
    const float e = rescale<NS>(x);
    const int dst = row[6];
#pragma unroll
    for (int j = 0; j < NS; ++j) my[(dst * (NS + 1) + j) * nthr] = x[j];
    my[(dst * (NS + 1) + NS) * nthr] = s[0] + s[1] + e;
  }

  // root: sum_x pi * clv, then log-sum-exp over classes
  const int rd = sched[7 * (n_int - 1) + 6];
  float l = 0.0f;
#pragma unroll
  for (int x = 0; x < NS; ++x) l += pi[c * NS + x] * my[(rd * (NS + 1) + x) * nthr];
  l = fmaxf(l, FLT_MIN);
  red[c * tp + lp] = logw[c] + my[(rd * (NS + 1) + NS) * nthr] * kLn2 + logf(l);
  __syncthreads();
  if (c == 0 && p < P) out[p] = class_lse(red + lp, C, tp);
}

template <int NS>
int launch_slot(const int* sched, const float* tips, const float* pmats,
                const float* pi, const float* logw, float* out, int n_int,
                int n_slots, int C, int P, int tp, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(n_slots) * (NS + 1) + 1) * tp * C * sizeof(float);
  cudaError_t err = allow_smem(slot_site_lse_kernel<NS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(tp, C), grid((P + tp - 1) / tp);
  slot_site_lse_kernel<NS><<<grid, block, smem, stream>>>(
      sched, tips, pmats, pi, logw, out, n_int, n_slots, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace phyml

extern "C" int phyml_slot_site_lse(const int* sched, const float* tips,
                                   const float* pmats, const float* pi,
                                   const float* logw, float* out, int n_int,
                                   int n_slots, int ns, int C, int P, int tp,
                                   void* stream) {
  if (tp * C > 1024) return phyml::kUnsupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 4:
      return phyml::launch_slot<4>(sched, tips, pmats, pi, logw, out, n_int,
                                   n_slots, C, P, tp, st);
    case 20:
      return phyml::launch_slot<20>(sched, tips, pmats, pi, logw, out, n_int,
                                    n_slots, C, P, tp, st);
    default:
      return phyml::kUnsupported;
  }
}
