// Host launchers of the big bodies past the ladder (csrc/big.cuh gives
// their design): declarations only, so that the ladder's translation
// units (clv.cu, slots.cuh, edotp.cuh), whose extern "C" entries
// dispatch a state count past the top rung to them, compile the same
// device code as without them.
#pragma once

#include <cuda_runtime.h>

namespace phyml {

// Each returns kUnsupported for a state count that is not a big width
// (big_width), a shape whose block does not fit kMaxSmem, or a grid
// past the card's limits; else the cudaError_t of the launch.

// K3 (batched = true: grid (B, tiles), kernel big_uppass_kernel) and K4
// with K1's entry (batched = false, B = 1: big_slot_kernel).  tips rows
// lie ldt floats apart (K3: P; K4: the padded row), a tip's NSp rows
// NSp * ldt apart.
int big_pass_launch(bool batched, const int* sched, const float* tips,
                    const float* pmats, const float* pi, const float* logw,
                    float* out, int n_otu, int n_int, int n_slots, int NSp,
                    int C, int P, int ldt, int B, int sched_stride,
                    int param_stride, cudaStream_t stream);
int big_pass_occupancy(bool batched, int NSp, int C, int n_slots,
                       int* blocks_per_sm);

// K5 with K2's entry: grid (Pw / 16, C, R trees), kernel
// big_edotp_kernel.
int big_edotp_launch(const int* child, const float* tips,
                     const float* pmats, const float* V, const float* Vinv,
                     const float* pi, float* d, float* scd, float* ws_clv,
                     float* ws_out, int n_otu, int n_int, int NSp, int C,
                     int P, int Pw, int R, cudaStream_t stream);
int big_edotp_occupancy(int NSp, int* blocks_per_sm);

}  // namespace phyml
