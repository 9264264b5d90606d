// K4: slot-scheduled Felsenstein pass with the P-matrices and tip rows
// streamed through a shared-memory ring; variable-rate site lnL.
//
// Replaces phyml_tpu/ops/pallas_clv_slots.py:_slot_stream_kernel
// (wrapper uppass_site_lse_slots_stream).  It computes K1's function
// (clv_slots.cu) over the same Sethi-Ullman schedule, with the same
// slots in shared memory ([slot][ns+1][thread]).  What differs is
// where each step's operands come from: K1 reads a step's two
// P-matrices through L1/L2, a dependent load on every matvec, which is
// cheap while the whole tree's P-matrices stay close to one SM (128
// taxa DNA: 65 KB) and is not once they do not (128 taxa amino acids:
// 1.6 MB).  Here the block copies step i+1's two P-matrices (C*ns^2
// floats each, 6.4 KB at ns = 20, C = 4) and its tip rows into one half
// of a double-buffered ring with cp.async while step i computes from
// the other half; every matvec then reads its matrix from shared
// memory, as a broadcast across the warp.
//
// What bounds it on the H100: the matvecs, 2*C*ns^2 FLOPs per child
// and pattern (about 3.3 GFLOP at 128 x 4096 amino acids, C = 4), and
// the per-step latency of the schedule walk, which the ring hides
// behind the step before.  Shared memory at ns = 20, C = 4, 128 taxa:
// 97 KB of slots and 36 KB of ring for a 128-thread block.
#include "common.cuh"

namespace phyml {

template <int NS>
__global__ void slot_site_lse_stream_kernel(const int* __restrict__ sched,
                                            const float* __restrict__ tips,
                                            const float* __restrict__ pmats,
                                            const float* __restrict__ pi,
                                            const float* __restrict__ logw,
                                            float* __restrict__ out, int n_int,
                                            int n_slots, int P) {
  extern __shared__ __align__(16) float smem[];
  const int tp = blockDim.x, C = blockDim.y;
  const int lp = threadIdx.x, c = threadIdx.y;
  const int tid = c * tp + lp, nthr = tp * C;
  const int p0 = blockIdx.x * tp;
  const int p = p0 + lp;
  const int mat = C * NS * NS;  // floats of one node's P-matrices
  // ring: pm_ring[stage][child][mat], tip_ring[stage][child][NS][tp]
  float* pm_ring = smem;
  float* tip_ring = pm_ring + 4 * mat;
  // this thread's slot entries: slot s, state x at my[(s*(NS+1)+x)*nthr];
  // entry NS holds the slot's log2 scale
  float* slots = tip_ring + 4 * NS * tp;
  float* my = slots + tid;
  float* red = slots + static_cast<size_t>(n_slots) * (NS + 1) * nthr;

  // issue the copies of step i's operands into ring half `stage`
  auto fetch = [&](int i, int stage) {
    const int* row = sched + 7 * i;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int cid = row[3 * k];
      copy_block16(pm_ring + (2 * stage + k) * mat,
                   pmats + static_cast<size_t>(cid) * mat, mat, tid, nthr);
      if (row[3 * k + 1])
        copy_tip_rows<NS>(tip_ring + (2 * stage + k) * NS * tp,
                          tips + static_cast<size_t>(cid) * NS * P, p0, P, tp,
                          tid, nthr);
    }
    cp_async_commit();
  };

  fetch(0, 0);
  for (int i = 0; i < n_int; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_int)
      fetch(i + 1, stage ^ 1);
    else
      cp_async_commit();  // empty group: keeps the wait below uniform
    cp_async_wait<1>();   // this thread's copies of step i have landed
    __syncthreads();      // ... and every other thread's

    const int* row = sched + 7 * i;
    float x[NS], s = 0.0f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int is_tip = row[3 * k + 1], sl = row[3 * k + 2];
      float clv[NS], v[NS];
      if (is_tip) {
        const float* t = tip_ring + (2 * stage + k) * NS * tp + lp;
#pragma unroll
        for (int j = 0; j < NS; ++j) clv[j] = t[j * tp];
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) clv[j] = my[(sl * (NS + 1) + j) * nthr];
        s += my[(sl * (NS + 1) + NS) * nthr];
      }
      matvec<NS>(pm_ring + (2 * stage + k) * mat + c * NS * NS, clv, v);
      if (k == 0) {
#pragma unroll
        for (int j = 0; j < NS; ++j) x[j] = v[j];
      } else {
#pragma unroll
        for (int j = 0; j < NS; ++j) x[j] *= v[j];
      }
    }
    const float e = rescale<NS>(x);
    const int dst = row[6];
#pragma unroll
    for (int j = 0; j < NS; ++j) my[(dst * (NS + 1) + j) * nthr] = x[j];
    my[(dst * (NS + 1) + NS) * nthr] = s + e;
    __syncthreads();  // ring half `stage` is free for step i + 2
  }

  // root: sum_x pi * clv, then log-sum-exp over classes
  const int rd = sched[7 * (n_int - 1) + 6];
  float l = 0.0f;
#pragma unroll
  for (int x = 0; x < NS; ++x)
    l += pi[c * NS + x] * my[(rd * (NS + 1) + x) * nthr];
  l = fmaxf(l, FLT_MIN);
  red[c * tp + lp] =
      logw[c] + my[(rd * (NS + 1) + NS) * nthr] * kLn2 + logf(l);
  __syncthreads();
  if (c == 0 && p < P) out[p] = class_lse(red + lp, C, tp);
}

template <int NS>
int launch_slot_stream(const int* sched, const float* tips,
                       const float* pmats, const float* pi, const float* logw,
                       float* out, int n_int, int n_slots, int C, int P,
                       int tp, cudaStream_t stream) {
  const size_t smem =
      (4 * static_cast<size_t>(C) * NS * NS + 4 * NS * tp +
       (static_cast<size_t>(n_slots) * (NS + 1) + 1) * tp * C) *
      sizeof(float);
  if (smem > kMaxSmem) return kUnsupported;
  cudaError_t err = allow_smem(slot_site_lse_stream_kernel<NS>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(tp, C), grid((P + tp - 1) / tp);
  slot_site_lse_stream_kernel<NS><<<grid, block, smem, stream>>>(
      sched, tips, pmats, pi, logw, out, n_int, n_slots, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace phyml

extern "C" int phyml_slot_site_lse_stream(const int* sched, const float* tips,
                                          const float* pmats, const float* pi,
                                          const float* logw, float* out,
                                          int n_int, int n_slots, int ns,
                                          int C, int P, int tp, void* stream) {
  if (tp * C > 1024) return phyml::kUnsupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ns) {
    case 4:
      return phyml::launch_slot_stream<4>(sched, tips, pmats, pi, logw, out,
                                          n_int, n_slots, C, P, tp, st);
    case 20:
      return phyml::launch_slot_stream<20>(sched, tips, pmats, pi, logw, out,
                                           n_int, n_slots, C, P, tp, st);
    default:
      return phyml::kUnsupported;
  }
}
