// Shared device helpers for the Felsenstein-pruning kernels.
//
// Every kernel runs one warp per rate class and gives each thread a
// register tile of R states x Q patterns (tile_matmul below; a pattern
// column split over NS / R adjacent lanes), its operands staged in
// shared memory by cp.async.  The arithmetic is plain IEEE float32:
// build without --use_fast_math, since flush-to-zero and the
// approximate logf/expf would change the results.
//
// The kernels are instantiated for ns = 4 (DNA) and ns = 20 (amino
// acids); the build log's ptxas report shows each instantiation's
// registers and spills.
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

// ---- register tiles ---------------------------------------------------

// Q consecutive floats, 4 * Q-byte aligned: v[j] = p[j] / p[j] = v[j]
template <int Q>
__device__ __forceinline__ void load_q(const float* p, float (&v)[Q]) {
  if constexpr (Q == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (Q == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    static_assert(Q == 1, "Q is 1, 2 or 4");
    v[0] = *p;
  }
}

template <int Q>
__device__ __forceinline__ void store_q(float* p, const float (&v)[Q]) {
  if constexpr (Q == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (Q == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// acc[i][j] = sum_y pm[i * NS + y] * x[y * T + j]: R rows of one
// row-major NS x NS matrix (16-byte aligned rows) times Q columns of an
// [NS][T] tile, summed over y in order.  R * Q FMAs for
// every 16-byte piece of the matrix and every Q-piece of the tile.
template <int NS, int R, int Q>
__device__ __forceinline__ void tile_matmul(const float* __restrict__ pm,
                                            const float* __restrict__ x,
                                            int T, float (&acc)[R][Q]) {
  static_assert(NS % 4 == 0, "rows are read in 16-byte pieces");
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int y0 = 0; y0 < NS; y0 += 4) {
    float4 p[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      p[i] = *reinterpret_cast<const float4*>(pm + i * NS + y0);
    float v[4][Q];
#pragma unroll
    for (int u = 0; u < 4; ++u) load_q<Q>(x + (y0 + u) * T, v[u]);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float pr[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < Q; ++j) acc[i][j] += pr[u] * v[u][j];
    }
  }
}

// The transposed product: acc[i][j] = sum_w pm[w * NS + i] * x[w * T + j]
// (pm points at the first of the R output columns), summed over w in
// order.  R scalar matrix loads per Q-piece of the tile.
template <int NS, int R, int Q>
__device__ __forceinline__ void tile_matmul_t(const float* __restrict__ pm,
                                              const float* __restrict__ x,
                                              int T, float (&acc)[R][Q]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < Q; ++j) acc[i][j] = 0.0f;
#pragma unroll
  for (int w = 0; w < NS; ++w) {
    float v[Q];
    load_q<Q>(x + w * T, v);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float p = pm[w * NS + i];
#pragma unroll
      for (int j = 0; j < Q; ++j) acc[i][j] += p * v[j];
    }
  }
}

// sum / max of v over the G adjacent lanes of a pattern column
template <int G>
__device__ __forceinline__ float column_sum(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int G>
__device__ __forceinline__ float column_max(float v) {
#pragma unroll
  for (int o = 1; o < G; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Exact power-of-two rescale of the Q columns of an R x Q register tile
// whose columns are split over G lanes: each column is multiplied in
// place by 2^(127-e), e the biased exponent of its max over all its
// states (floored at FLT_MIN), and e - 127 is added to s[j]: the
// exponent bits make the factor exact
// (phyml_tpu/ops/pallas_clv_slots.py:189-196).
template <int G, int R, int Q>
__device__ __forceinline__ void rescale_tile(float (&v)[R][Q],
                                             float (&s)[Q]) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    float m = v[0][j];
#pragma unroll
    for (int r = 1; r < R; ++r) m = fmaxf(m, v[r][j]);
    m = fmaxf(column_max<G>(m), FLT_MIN);
    const int e = (__float_as_int(m) >> 23) & 0xFF;
    const float f = __int_as_float((254 - e) << 23);
#pragma unroll
    for (int r = 0; r < R; ++r) v[r][j] *= f;
    s[j] += static_cast<float>(e - 127);
  }
}

// log-sum-exp over the C class values a[c * tp] of one pattern.
__device__ __forceinline__ float class_lse(const float* a, int C, int tp) {
  float amax = a[0];
  for (int c = 1; c < C; ++c) amax = fmaxf(amax, a[c * tp]);
  float s = 0.0f;
  for (int c = 0; c < C; ++c) s += expf(a[c * tp] - amax);
  return amax + logf(s);
}

// ---- the slot schedule (K1, K3, K4) ---------------------------------

// True where row i of a slot schedule (ops/clv_slots.py:
// build_slot_schedule; 7 ints a row) lies outside the launch: a slot
// outside [0, n_slot), a tip outside [0, n_tip) or an internal child
// outside [0, n_child).  The kernels check every row once per block and
// trap, since the slots and the matrices index shared memory.
__device__ __forceinline__ bool schedule_row_bad(const int* __restrict__ sched,
                                                 int i, unsigned n_tip,
                                                 unsigned n_child,
                                                 unsigned n_slot) {
  const int* st = sched + 7 * i;
  bool bad = static_cast<unsigned>(st[6]) >= n_slot;
#pragma unroll
  for (int k = 0; k < 2; ++k)
    bad |= st[3 * k + 1] ? static_cast<unsigned>(st[3 * k]) >= n_tip
                         : static_cast<unsigned>(st[3 * k]) >= n_child ||
                               static_cast<unsigned>(st[3 * k + 2]) >= n_slot;
  return bad;
}

// ---- cp.async: asynchronous global -> shared copies -----------------
// Every kernel stages a schedule step's operands (P-matrices, tip rows,
// partials) in a shared-memory ring: the copies for a later step are
// issued while an earlier one computes, and a thread waits for its own
// copies with cp.async.wait_group, then its warp or block meets at a
// barrier so that every thread's copies are visible.

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

// The whole block copies `rows` rows of T floats (T a multiple of 4),
// row r from src + r * stride to dst + r * T; every row start
// 16-byte aligned at both ends.
template <int T>
__device__ __forceinline__ void copy_rows16(float* dst,
                                           const float* __restrict__ src,
                                           int rows, size_t stride, int tid,
                                           int nthr) {
  static_assert(T % 4 == 0, "rows are copied in 16-byte pieces");
  constexpr int kPer = T / 4;
  for (int k = tid; k < rows * kPer; k += nthr) {
    const int r = k / kPer, q = k - r * kPer;
    cp_async16(dst + r * T + 4 * q, src + r * stride + 4 * q);
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
