// Shared device helpers for the Felsenstein-pruning kernels.
//
// Every kernel here runs one thread per (site pattern, rate class):
// threadIdx.x walks a tile of patterns, threadIdx.y is the class.
// Neighbouring threads of a warp therefore read neighbouring pattern
// columns of every [.., P] array, while all of them read the same
// P-matrix entry (a broadcast from L1, or from shared memory in the
// streamed kernels).  The arithmetic is plain IEEE float32: build
// without --use_fast_math, since flush-to-zero and the approximate
// logf/expf would change the results.
//
// The kernels are instantiated for ns = 4 (DNA) and ns = 20 (amino
// acids).  At ns = 20 a thread's state vectors are 20 floats each, so
// K2/K5 keep few of them live at once there (see kHoldPartials) to
// stay clear of register spills; the build log's ptxas report shows
// it.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace phyml {

constexpr float kLn2 = 0.6931471805599453f;

// Return code for a (ns, C) combination this build has no kernel for.
constexpr int kUnsupported = -1;

// Shared memory one block may use on Hopper (227 KB).
constexpr size_t kMaxSmem = 232448;

// Exact power-of-two rescale of one partial vector: the column max m
// (floored at FLT_MIN) has biased exponent e, and multiplying by
// 2^(127-e) brings it into [1, 2) without rounding.  Returns the log2
// scale added, e - 127 (phyml_tpu/ops/pallas_clv_slots.py:189-196).
template <int NS>
__device__ __forceinline__ float rescale(float (&x)[NS]) {
  float m = x[0];
#pragma unroll
  for (int i = 1; i < NS; ++i) m = fmaxf(m, x[i]);
  m = fmaxf(m, FLT_MIN);
  const int e = (__float_as_int(m) >> 23) & 0xFF;
  const float factor = __int_as_float((254 - e) << 23);
#pragma unroll
  for (int i = 0; i < NS; ++i) x[i] *= factor;
  return static_cast<float>(e - 127);
}

// y = pm @ x for one row-major NS x NS matrix.
template <int NS>
__device__ __forceinline__ void matvec(const float* __restrict__ pm,
                                       const float (&x)[NS],
                                       float (&y)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float acc = pm[i * NS] * x[0];
#pragma unroll
    for (int j = 1; j < NS; ++j) acc += pm[i * NS + j] * x[j];
    y[i] = acc;
  }
}

// y = pm^T @ x (contracts the matrix's first axis).
template <int NS>
__device__ __forceinline__ void matvec_t(const float* __restrict__ pm,
                                         const float (&x)[NS],
                                         float (&y)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float acc = pm[i] * x[0];
#pragma unroll
    for (int w = 1; w < NS; ++w) acc += pm[w * NS + i] * x[w];
    y[i] = acc;
  }
}

// Whether the edge-dot-product kernels (K2, K5) hold a step's two
// child partials in registers and form whole vectors for their d
// (ns = 4), or load each partial again and store d row by row with
// eigen_dot_rows (ns = 20, where holding them spills).
template <int NS>
constexpr bool kHoldPartials = NS <= 4;

// One pattern column of an edge's eigen-basis dot products, row by
// row: out[j * stride] = (V^T o)[j] * (V^-1 x)[j], each row stored as
// soon as its two dot products are formed (the same sums, in the same
// order, as matvec_t and matvec), so no whole vector stays live.
template <int NS>
__device__ __forceinline__ void eigen_dot_rows(const float* __restrict__ V,
                                               const float* __restrict__ Vinv,
                                               const float (&o)[NS],
                                               const float (&x)[NS],
                                               float* __restrict__ out,
                                               size_t stride) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float a = V[j] * o[0], b = Vinv[j * NS] * x[0];
#pragma unroll
    for (int z = 1; z < NS; ++z) {
      a += V[z * NS + j] * o[z];
      b += Vinv[j * NS + z] * x[z];
    }
    out[j * stride] = a * b;
  }
}

// Strided column load/store: v[x] = base[x * stride] (one pattern
// column of an [.., NS, P] array).
template <int NS>
__device__ __forceinline__ void load_col(const float* __restrict__ base,
                                         size_t stride, float (&v)[NS]) {
#pragma unroll
  for (int x = 0; x < NS; ++x) v[x] = base[x * stride];
}

template <int NS>
__device__ __forceinline__ void store_col(float* __restrict__ base,
                                          size_t stride,
                                          const float (&v)[NS]) {
#pragma unroll
  for (int x = 0; x < NS; ++x) base[x * stride] = v[x];
}

// log-sum-exp over the C class values a[c * tp] of one pattern.
__device__ __forceinline__ float class_lse(const float* a, int C, int tp) {
  float amax = a[0];
  for (int c = 1; c < C; ++c) amax = fmaxf(amax, a[c * tp]);
  float s = 0.0f;
  for (int c = 0; c < C; ++c) s += expf(a[c * tp] - amax);
  return amax + logf(s);
}

// ---- cp.async: asynchronous global -> shared copies -----------------
// The streamed kernels (K4, K5) stage each schedule step's P-matrices
// and tip rows in a double-buffered shared-memory ring: the copies for
// step i+1 are issued before step i computes, and a thread waits for
// its own copies with cp.async.wait_group, then the block meets at a
// barrier so every thread's copies are visible.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes, cached in L2 only; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

// 4 bytes (below 16 bytes cp.async only has the .ca form).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

// Close the group of copies issued since the last commit (an empty
// group is allowed).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The whole block copies n floats (n a multiple of 4, both ends
// 16-byte aligned) from global to shared memory.
__device__ __forceinline__ void copy_block16(float* dst,
                                             const float* __restrict__ src,
                                             int n, int tid, int nthr) {
  for (int k = 4 * tid; k < n; k += 4 * nthr) cp_async16(dst + k, src + k);
}

// The whole block copies one tip's rows for its pattern tile:
// dst[x * tp + l] = row[x * P + min(p0 + l, P - 1)] for x < NS, l < tp
// (the ragged edge repeats the last column, which is never stored).
template <int NS>
__device__ __forceinline__ void copy_tip_rows(float* dst,
                                              const float* __restrict__ row,
                                              int p0, int P, int tp, int tid,
                                              int nthr) {
  for (int k = tid; k < NS * tp; k += nthr) {
    const int x = k / tp, l = k - x * tp;
    const int col = p0 + l < P ? p0 + l : P - 1;
    cp_async4(dst + k, row + static_cast<size_t>(x) * P + col);
  }
}

// Raise the dynamic shared-memory cap of `kernel` when a launch needs
// more than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace phyml
