// Shared device helpers for the Felsenstein-pruning kernels.
//
// Every kernel here runs one thread per (site pattern, rate class):
// threadIdx.x walks a tile of patterns, threadIdx.y is the class.
// Neighbouring threads of a warp therefore read neighbouring pattern
// columns of every [.., P] array, while all of them read the same
// P-matrix entry (a broadcast from L1).  The arithmetic is plain IEEE
// float32: build without --use_fast_math, since flush-to-zero and the
// approximate logf/expf would change the results.
#pragma once

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace phyml {

constexpr float kLn2 = 0.6931471805599453f;

// Return code for a (ns, C) combination this build has no kernel for.
constexpr int kUnsupported = -1;

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
