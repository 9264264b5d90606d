// K6: the edge-length Newton solve, one launch a solve.
//
// Replaces no TPU kernel: the JAX package runs this loop in jnp under
// fori_loop (phyml_tpu/search/nni.py, optim/blen.py, search/spr.py).
// The port ran it as ~72 PyTorch operations an iteration
// (LikelihoodEngine.edge_site_terms + edge_lnl_terms, then the step),
// six of them full-size [rows, C, ns, P] broadcasting multiplies.
//
// What it computes: for every row r (one edge length t[r], its
// eigen-basis dot products d[r] [C, ns, P] and scales sc[r] [C, P]),
// `iters` safeguarded Newton steps on t[r].  An iteration is
//   s_k[c, p] = sum_i d[c, i, p] lam[c, i]^k e^{lam[c, i] t}   (k = 0, 1, 2)
//   A_k[p]    = sum_c w_c e^{sc[c, p] - m[p]} s_k[c, p],  m = max_c sc
//   site[p]   = log A_0 + m (the +I mix through logaddexp where the
//               model has it), and the two derivative ratios of
//               edge_site_terms with the same clamps and signs,
// in float32, then the three weighted pattern sums in float64
// (edge_lnl_terms), then ops/newton.py::_step: the Newton step, a
// multiplicative probe where the curvature is useless, a factor-of-3
// clamp, [BL_MIN, BL_MAX] and the optional row mask.  The sums over
// states and classes run in the plain version's order (ascending, one
// accumulator), but as fused multiply-adds of d with the coefficients
// lam^k e^{lam t} where the plain version rounds (d lam) e^{lam t}, and
// with CUDA's IEEE-accurate expf/logf (1-2 ulp from the CPU's): the
// lengths differ from the plain version's by rounding only.
//
// Bound: bytes.  An iteration must read d once, rows x C x ns x P x 4
// bytes (the 20-state NNI solve of a 120 x 10,240 alignment: 1.097 GB,
// 0.33 ms at 3.35 TB/s); the arithmetic is 3 FMAs an element of d, the
// coefficients depend only on (class, state).
//
// Design:
// - A row's iterations all run in the block (or cluster) that owns the
//   row, so the step is taken in the kernel and the whole solve is one
//   launch; no intermediate of d's size touches device memory.
// - The coefficients (e^{lam t}, lam e^{lam t}, lam^2 e^{lam t}) of
//   the row sit in shared memory, one float4 a (class, state),
//   recomputed once an iteration.  Each thread holds kNewtonPatterns
//   patterns kNewtonThreads apart, so a warp's loads of one (class,
//   state) are 128 contiguous bytes, addressed from one pointer with
//   immediate offsets; it reads d once an iteration, the loads of
//   kNewtonUnroll states (16) in flight together, and the last partial
//   step apart so that whole steps carry no bounds checks.  Blocks of
//   128 threads at up to 128 registers leave 4 blocks an SM; of the
//   shapes tried (2-8 patterns a thread, 2-16 states in flight, 4-8
//   blocks an SM) this ran fastest at the benchmark's shapes.
// - Rows and SMs: a row's patterns are split over a thread-block cluster
//   of cs blocks, 1 <= cs <= kNewtonClusterMax (each block at least
//   kNewtonMinSlice patterns), whose partial sums meet in distributed
//   shared memory.  The launcher takes the fewest blocks that fill the
//   device's resident slots best over whole waves (the runtime's count
//   of clusters of cs blocks it holds at once): on an H100, 351 NNI rows
//   take 4 blocks a row, 239 branch-length rows 2; many rows 1.  No
//   knob: rows, patterns and the card's occupancy decide.  Every block
//   of a cluster adds the partials in rank order and takes the same
//   step, so the lengths agree without another barrier; the partials
//   are double-buffered by iteration, one cluster barrier an iteration.
// - Sums in a fixed order (warp shuffles, then warps, then ranks), so a
//   solve gives the same lengths run to run.
// - Operands by strides: d's rows, classes and states, sc's rows (the
//   NNI scorer's stride-0 expand over the three configurations) and
//   classes, t's and the mask's rows; the pattern axis is contiguous.
//   Weights [G, P] in float64, one row for each run of rows / G rows.
//   ns and C are run-time arguments: nothing is padded.
// - A sharded engine adds the pattern sums over its ranks before each
//   step: the second entry (phyml_edge_newton_sums) runs one iteration
//   without the step and writes the three row sums.
#include <cooperative_groups.h>

#include <cfloat>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>
#include <mutex>
#include <vector>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace phyml {

constexpr int kNewtonThreads = 128;
constexpr int kNewtonWarps = kNewtonThreads / 32;
constexpr int kNewtonBlocksPerSm = 4;  // 512 threads an SM: <= 128 registers
constexpr int kNewtonPatterns = 4;     // patterns a thread holds at once
constexpr int kNewtonUnroll = 4;       // states whose loads are in flight
constexpr int kNewtonClusterMax = 8;   // blocks a row is split over at most
constexpr int kNewtonMinSlice = 2 * kNewtonThreads;  // patterns a block takes
constexpr double kBlMin = 1e-8;        // optim/blen.py BL_MIN
constexpr double kBlMax = 100.0;       // optim/blen.py BL_MAX

struct NewtonOperands {
  const float* d;
  const float* sc;
  const float* t_in;
  const unsigned char* mask;  // nullptr: every row steps
  const double* wts;
  const float* lam;       // [C, ns]
  const float* wcls;      // [C]
  const float* pinv;      // [1]
  const float* inv_lk;    // [P]
  const float* invar_ok;  // [P]
  float* t_out;           // [rows], or nullptr (the sums entry)
  double* sums;           // [3, rows], or nullptr (the solve)
  // strides in elements; a row r is (r / lead_b, r % lead_b)
  long long d_a, d_b, d_c, d_s, sc_a, sc_b, sc_c, t_a, t_b, m_a, m_b, w_row;
  int rows, lead_b, C, ns, P, iters, invar, w_group, cs;
};

// torch.maximum / torch.minimum / torch.clamp: NaN in, NaN out
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}
__device__ __forceinline__ double min_nan(double a, double b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
// torch.clamp(x, min=FLT_MIN)
__device__ __forceinline__ float at_least_tiny(float x) {
  return x < FLT_MIN ? FLT_MIN : x;
}
// torch.sign
__device__ __forceinline__ float sign_of(float x) {
  return static_cast<float>((x > 0.0f) - (x < 0.0f));
}
// torch.logaddexp
__device__ __forceinline__ float log_add_exp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = a < b ? b : a;
  return m + log1pf(expf(-fabsf(a - b)));
}

// One step of a thread over its patterns base + j T, j < K (kFull:
// all of them below hi): adds each pattern's weighted (site lnL, d/dt,
// d2/dt2) to acc, in float64.  d0 and s0p point at pattern base of the
// row's d and sc; each load's j T is an immediate offset.
template <bool kFull>
__device__ __forceinline__ void pattern_step(
    const NewtonOperands& op, const float* __restrict__ d0,
    const float* __restrict__ s0p, const double* __restrict__ wrow,
    const float4* coef, int base, int hi, float pinv, float one_m_p,
    float log_one_m_p, double (&acc)[3]) {
  constexpr int K = kNewtonPatterns;
  constexpr int T = kNewtonThreads;
  const int C = op.C, ns = op.ns;
  bool ok[K];
  float m[K], A0[K], A1[K], A2[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    ok[j] = kFull || base + j * T < hi;
    m[j] = -INFINITY;
    A0[j] = A1[j] = A2[j] = 0.0f;
  }
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (ok[j]) m[j] = max_nan(m[j], __ldg(s0p + c * op.sc_c + j * T));
  for (int c = 0; c < C; ++c) {
    const float4* cc = coef + c * ns;
    float s0[K], s1[K], s2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) s0[j] = s1[j] = s2[j] = 0.0f;
#pragma unroll (kNewtonUnroll)
    for (int i = 0; i < ns; ++i) {
      const float4 k = cc[i];  // e^{lam t}, lam e^{lam t}, lam^2 e^{lam t}
      const float* di = d0 + (c * op.d_c + i * op.d_s);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float x = ok[j] ? __ldg(di + j * T) : 0.0f;
        s0[j] += x * k.x;
        s1[j] += x * k.y;
        s2[j] += x * k.z;
      }
    }
    const float wc = __ldg(op.wcls + c);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float ew =
          ok[j] ? wc * expf(__ldg(s0p + c * op.sc_c + j * T) - m[j]) : 0.0f;
      A0[j] += ew * s0[j];
      A1[j] += ew * s1[j];
      A2[j] += ew * s2[j];
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (!ok[j]) continue;
    const int p = base + j * T;
    const float a0 = at_least_tiny(A0[j]);
    float site;
    if (op.invar) {
      const float log_var = log_one_m_p + logf(a0) + m[j];
      const float inv = logf(at_least_tiny(pinv * __ldg(op.inv_lk + p)));
      site = __ldg(op.invar_ok + p) > 0.0f ? log_add_exp(log_var, inv)
                                            : log_var;
    } else {
      site = logf(a0) + m[j];
    }
    // d site / dt = (1-p) A1 e^{m - site}; stable in both regimes
    const float r1 = one_m_p *
                     expf(logf(at_least_tiny(fabsf(A1[j]))) + m[j] - site) *
                     sign_of(A1[j]);
    const float r2 = one_m_p *
                     expf(logf(at_least_tiny(fabsf(A2[j]))) + m[j] - site) *
                     sign_of(A2[j]);
    const float curv = r2 - r1 * r1;
    const double w = __ldg(wrow + p);
    acc[0] += static_cast<double>(site) * w;
    acc[1] += static_cast<double>(r1) * w;
    acc[2] += static_cast<double>(curv) * w;
  }
}

// The block's patterns [lo, hi) of one row: whole steps of K patterns a
// thread, then at most one partial step.
__device__ __forceinline__ void row_terms(const NewtonOperands& op,
                                          const float* drow,
                                          const float* srow,
                                          const double* wrow,
                                          const float4* coef, int lo, int hi,
                                          float pinv, float one_m_p,
                                          float log_one_m_p,
                                          double (&acc)[3]) {
  constexpr int K = kNewtonPatterns;
  constexpr int T = kNewtonThreads;
  int base = lo + static_cast<int>(threadIdx.x);
  for (; base + (K - 1) * T < hi; base += K * T)
    pattern_step<true>(op, drow + base, srow + base, wrow, coef, base, hi,
                       pinv, one_m_p, log_one_m_p, acc);
  if (base < hi)
    pattern_step<false>(op, drow + base, srow + base, wrow, coef, base, hi,
                        pinv, one_m_p, log_one_m_p, acc);
}

// ops/newton.py::_step on one length: the float64 step, rounded to
// float32 at the end as `.to(t0.dtype)` rounds it
__device__ __forceinline__ float newton_step(float t, double d1, double d2,
                                             float t0, bool frozen) {
  const double newton = static_cast<double>(t) - d1 / (d2 < 0.0 ? d2 : -1.0);
  const float up = t * 3.0f, down = t / 3.0f;
  const double probe = d1 > 0.0 ? up : down;
  double tn = d2 < -1e-12 ? newton : probe;
  tn = min_nan(max_nan(tn, static_cast<double>(down)),
               static_cast<double>(up));
  tn = tn != tn ? tn : fmin(fmax(tn, kBlMin), kBlMax);
  if (frozen) tn = t0;
  return __double2float_rn(tn);
}

__global__ void __launch_bounds__(kNewtonThreads, kNewtonBlocksPerSm)
    edge_newton_kernel(const NewtonOperands op) {
  // (e^{lam t}, lam e^{lam t}, lam^2 e^{lam t}, lam) by (class, state)
  extern __shared__ float4 coef[];
  __shared__ double warp_part[kNewtonWarps][3];
  __shared__ double part[2][3];    // this block's sums, by iteration parity
  __shared__ float t_s;
  const int cs = op.cs;
  const int row = blockIdx.x / cs, rank = blockIdx.x % cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long ra = row / op.lead_b, rb = row % op.lead_b;
  const int CN = op.C * op.ns;
  for (int k = tid; k < CN; k += kNewtonThreads) coef[k].w = op.lam[k];
  const float t0 = op.t_in[ra * op.t_a + rb * op.t_b];
  const bool frozen = op.mask != nullptr && !op.mask[ra * op.m_a + rb * op.m_b];
  if (tid == 0) t_s = t0;
  // the block's slice of the patterns, a multiple of 32 wide
  const int chunk = ((op.P + cs - 1) / cs + 31) / 32 * 32;
  const int lo = min(op.P, rank * chunk), hi = min(op.P, lo + chunk);
  const float* drow = op.d + ra * op.d_a + rb * op.d_b;
  const float* srow = op.sc + ra * op.sc_a + rb * op.sc_b;
  const double* wrow = op.wts + static_cast<long long>(row / op.w_group) * op.w_row;
  const float pinv = *op.pinv, one_m_p = 1.0f - pinv;
  const float log_one_m_p = logf(one_m_p);
  __syncthreads();
  for (int it = 0; it < op.iters; ++it) {
    const float t = t_s;
    for (int k = tid; k < CN; k += kNewtonThreads) {
      const float l = coef[k].w, e = expf(l * t);
      coef[k].x = e;
      coef[k].y = l * e;
      coef[k].z = (l * l) * e;
    }
    __syncthreads();
    double acc[3] = {0.0, 0.0, 0.0};
    row_terms(op, drow, srow, wrow, coef, lo, hi, pinv, one_m_p,
              log_one_m_p, acc);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      double v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) warp_part[warp][k] = v;
    }
    __syncthreads();
    double* mine = part[it & 1];
    if (tid == 0)
      for (int k = 0; k < 3; ++k) {
        double s = 0.0;
        for (int w = 0; w < kNewtonWarps; ++w) s += warp_part[w][k];
        mine[k] = s;
      }
    if (cs > 1) cg::this_cluster().sync();
    if (tid == 0) {
      double S[3] = {0.0, 0.0, 0.0};
      for (int r = 0; r < cs; ++r) {
        const double* pr =
            cs > 1 ? cg::this_cluster().map_shared_rank(mine, r) : mine;
        for (int k = 0; k < 3; ++k) S[k] += pr[k];
      }
      if (op.sums != nullptr) {
        if (rank == 0)
          for (int k = 0; k < 3; ++k)
            op.sums[static_cast<long long>(k) * op.rows + row] = S[k];
      } else {
        t_s = newton_step(t, S[1], S[2], t0, frozen);
      }
    }
    __syncthreads();
  }
  // no block leaves while another of its cluster may read its partials
  if (cs > 1) cg::this_cluster().sync();
  if (op.t_out != nullptr && rank == 0 && tid == 0) op.t_out[row] = t_s;
}

size_t newton_smem(int C, int ns) {
  return static_cast<size_t>(C) * ns * sizeof(float4);
}

// Blocks of `cs`-block clusters the current device holds at once, kept
// by (device, shared memory, cs): the runtime's count does not change.
int newton_slots(int cs, size_t smem, int* slots) {
  struct Seen {
    int dev, cs, slots;
    size_t smem;
  };
  static std::mutex lock;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    std::lock_guard<std::mutex> hold(lock);
    for (const Seen& x : seen)
      if (x.dev == dev && x.cs == cs && x.smem == smem) {
        *slots = x.slots;
        return 0;
      }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs);
  cfg.blockDim = dim3(kNewtonThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cs == 1) {  // no cluster: blocks an SM times the SMs
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &clusters, edge_newton_kernel, kNewtonThreads, smem);
    clusters *= sms;
  } else {
    err = cudaOccupancyMaxActiveClusters(&clusters, edge_newton_kernel, &cfg);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *slots = clusters * cs;
  std::lock_guard<std::mutex> hold(lock);
  seen.push_back({dev, cs, *slots, smem});
  return 0;
}

// The cluster a row's patterns are split over on the current device (1:
// a block a row): of 1..kNewtonClusterMax blocks, each taking at least
// kNewtonMinSlice patterns, the fewest whose rows x cs blocks keep the
// most blocks busy a wave (blocks / waves, waves = blocks over the
// slots, rounded up; a larger cluster must gain 1 %).  *slots gets the
// slots of that cluster size.
int newton_cluster(int rows, int P, size_t smem, int* cs, int* slots) {
  cudaError_t err = allow_smem(edge_newton_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *cs = 1;
  double best = -1.0;
  for (int c = 1; c <= kNewtonClusterMax; ++c) {
    if (c > 1 && P / c < kNewtonMinSlice) break;
    int n = 0;
    const int rc = newton_slots(c, smem, &n);
    if (rc != 0) return rc;
    if (n < c) continue;
    const long long blocks = static_cast<long long>(rows) * c;
    const long long waves = (blocks + n - 1) / n;
    const double busy = static_cast<double>(blocks) / waves;
    if (busy > 1.01 * best) best = busy, *cs = c, *slots = n;
  }
  return best < 0.0 ? kUnsupported : 0;
}

int newton_launch(NewtonOperands op, cudaStream_t stream) {
  if (op.rows < 1 || op.lead_b < 1 || op.C < 1 || op.ns < 1 || op.P < 1 ||
      op.iters < 0 || op.w_group < 1)
    return kUnsupported;
  const size_t smem = newton_smem(op.C, op.ns);
  if (smem + 1024 > kMaxSmem) return kUnsupported;
  int slots = 0;
  const int rc = newton_cluster(op.rows, op.P, smem, &op.cs, &slots);
  if (rc != 0) return rc;
  if (static_cast<long long>(op.rows) * op.cs > INT_MAX) return kUnsupported;
  cudaError_t err;
  if (op.cs == 1) {
    edge_newton_kernel<<<op.rows, kNewtonThreads, smem, stream>>>(op);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(op.rows * op.cs);
  cfg.blockDim = dim3(kNewtonThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = op.cs;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, edge_newton_kernel, op);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

NewtonOperands newton_operands(const float* d, const float* sc,
                               const float* t_in, const unsigned char* mask,
                               const double* wts, const float* lam,
                               const float* wcls, const float* pinv,
                               const float* inv_lk, const float* invar_ok,
                               const long long* strides, int rows,
                               int lead_b, int C, int ns, int P, int iters,
                               int invar, int w_group) {
  NewtonOperands op = {};
  op.d = d, op.sc = sc, op.t_in = t_in, op.mask = mask, op.wts = wts;
  op.lam = lam, op.wcls = wcls, op.pinv = pinv, op.inv_lk = inv_lk;
  op.invar_ok = invar_ok;
  op.d_a = strides[0], op.d_b = strides[1], op.d_c = strides[2];
  op.d_s = strides[3], op.sc_a = strides[4], op.sc_b = strides[5];
  op.sc_c = strides[6], op.t_a = strides[7], op.t_b = strides[8];
  op.m_a = strides[9], op.m_b = strides[10], op.w_row = strides[11];
  op.rows = rows, op.lead_b = lead_b, op.C = C, op.ns = ns, op.P = P;
  op.iters = iters, op.invar = invar, op.w_group = w_group;
  return op;
}

}  // namespace phyml

// d sc t_in mask wts lam wcls pinv inv_lk invar_ok | t_out | strides
// (d_a d_b d_c d_s sc_a sc_b sc_c t_a t_b m_a m_b w_row) | rows lead_b C
// ns P iters invar w_group | stream
extern "C" int phyml_edge_newton(
    const float* d, const float* sc, const float* t_in,
    const unsigned char* mask, const double* wts, const float* lam,
    const float* wcls, const float* pinv, const float* inv_lk,
    const float* invar_ok, float* t_out, const long long* strides, int rows,
    int lead_b, int C, int ns, int P, int iters, int invar, int w_group,
    void* stream) {
  phyml::NewtonOperands op = phyml::newton_operands(
      d, sc, t_in, mask, wts, lam, wcls, pinv, inv_lk, invar_ok, strides,
      rows, lead_b, C, ns, P, iters, invar, w_group);
  op.t_out = t_out;
  return phyml::newton_launch(op, static_cast<cudaStream_t>(stream));
}

// The same body, one iteration and no step: sums [3, rows] (float64)
// gets each row's weighted sums of site lnL, d/dt and d2/dt2 over the
// patterns.  `iters` is ignored.
extern "C" int phyml_edge_newton_sums(
    const float* d, const float* sc, const float* t_in,
    const unsigned char* mask, const double* wts, const float* lam,
    const float* wcls, const float* pinv, const float* inv_lk,
    const float* invar_ok, double* sums, const long long* strides, int rows,
    int lead_b, int C, int ns, int P, int iters, int invar, int w_group,
    void* stream) {
  (void)iters;
  phyml::NewtonOperands op = phyml::newton_operands(
      d, sc, t_in, mask, wts, lam, wcls, pinv, inv_lk, invar_ok, strides,
      rows, lead_b, C, ns, P, 1, invar, w_group);
  op.sums = sums;
  return phyml::newton_launch(op, static_cast<cudaStream_t>(stream));
}

// geometry[0] the cluster a row is split over, [1] the blocks the device
// holds at once in such clusters, [2] its SMs, for `rows` rows of P
// patterns at (C, ns)
extern "C" int phyml_edge_newton_geometry(int rows, int P, int C, int ns,
                                          int* geometry) {
  const size_t smem = phyml::newton_smem(C, ns);
  if (smem + 1024 > phyml::kMaxSmem) return phyml::kUnsupported;
  int rc = phyml::newton_cluster(rows, P, smem, &geometry[0], &geometry[1]);
  if (rc != 0) return rc;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&geometry[2],
                                 cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}
