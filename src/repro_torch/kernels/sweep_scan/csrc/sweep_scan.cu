// The scheduler's fluid sweep engine for Hopper (sm_90a): every tick of a
// rate sweep of one or more candidate mappings, in float64.
//
// Replaces the XLA loop (not a Pallas kernel)
//   repro/core/simulator.py::_make_scan_kernel
// its tick loop `kernel` (a jax.lax.scan over ticks) and `batched_kernel`
// (a jax.vmap of it over candidate mappings), which the reference's
// SweepBatch.sweep_raw and search.evaluate_candidates run.  Same function,
// with the structure passed as arrays instead of being unrolled at trace
// time, so one build serves every DAG, shape bucket and fleet batch:
//   row_off  (T + 1)     groups of task row r are row_off[r] .. row_off[r+1]
//   edge_off (T + 1)     in-edges of row r are edge_off[r] .. edge_off[r+1],
//   edge_src, edge_mult  each with its source row and multiplier; the hop
//                        latency of edge e of candidate c is hops[c, e]
//   sink_off, sink_rows  the sink rows of each output (CSR; may be empty)
// Inputs caps (C, G, K), src_rate (T, K) shared by the candidates, g_frac
// and g_slot (C, G), hops (C, E).  Outputs queues and served (C, G, K),
// busy (C, S, K), realized (C, T, K) and lat (C, n_samples, n_out, K), all
// zeroed by the caller; best (C, T, K) is scratch.
//
// Per tick, for each task row in topological order (realized rates of the
// upstream rows are this tick's):
//   in_rate  = src_rate, or sum over in-edges of realized[src] * mult
//   per group g of the row: arr = in_rate * g_frac, q_len = queue + arr dt,
//     served = min(q_len, cap dt), queue = q_len - served
//   realized = (sum of the row's served) / dt   (in_rate when no groups)
// From tick s0 on, busy[g_slot] += served / cap (nothing where cap <= 0) and
// served_acc += served.  On ticks with step % sample_every == 0 (step 0
// included) the path latency is written: per row, the sum of
// g_frac (queue + 1) / cap over its groups with cap > 0, plus the max over
// in-edges of best[src] + hop; per output, the max of best over its sink
// rows (0 with none).
//
// Summation order and rounding are the numpy engine's (simulator.py
// `_sweep_numpy`), so the two agree to 1e-10 and in practice to the last
// bit: sums run in edge order and group order (np.add.at's order for the
// busy scatter), and every product and sum is rounded on its own
// (__dmul_rn / __dadd_rn) where numpy rounds twice, so nvcc cannot contract
// it into an FMA.  Padded groups (cap = frac = 0, slot 0: the mapper
// search's shape buckets) are exact no-ops.
//
// Design, right and simple: one thread per (candidate, rate column) runs all
// `steps` ticks in one launch.  A thread owns its column, so there are no
// atomics and no synchronisation; blocks run along K and the candidate is
// blockIdx.y.  State lives in device memory with K innermost, so a warp's
// loads and stores of one row coalesce, and it stays in L1/L2.
//
// Bound on an H100 SXM: the inputs and outputs are a few hundred KB and the
// float64 work a few tens of MFLOP at the paper's sizes (34e12 FP64 FLOP/s
// outside the tensor cores), so both the byte and the operation bound are
// microseconds.  What bounds this kernel is neither: it is the serial chain
// of steps ticks x rows in topological order, each a few dependent float64
// operations and L1 round trips, run by one thread.  At the paper's sizes
// it also fills few SMs: a grid-DAG search bucket is about 27 candidates x
// 11 rates, about 300 threads on 132 SMs.  Making it fast (all buckets in
// one launch, state in shared memory or registers, several columns per
// thread, a CUDA graph) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double ddiv(double a, double b) { return __ddiv_rn(a, b); }

__global__ void __launch_bounds__(kThreads)
    sweep_scan_kernel(const double* __restrict__ caps, const double* __restrict__ src_rate,
                      const double* __restrict__ g_frac, const int* __restrict__ g_slot,
                      const double* __restrict__ hops, const int* __restrict__ row_off,
                      const int* __restrict__ edge_off, const int* __restrict__ edge_src,
                      const double* __restrict__ edge_mult, const int* __restrict__ sink_off,
                      const int* __restrict__ sink_rows, double* queues, double* busy,
                      double* served_acc, double* realized, double* lat, double* best, int T,
                      int G, int S, int n_out, int K, int n_samples, int steps,
                      int sample_every, int s0, double dt) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const size_t c = blockIdx.y;
  const size_t Ks = static_cast<size_t>(K);
  const int E = edge_off[T];
  // this thread's column of each (C, X, K) array: element x is at [x * K]
  caps += c * G * Ks + k;
  queues += c * G * Ks + k;
  served_acc += c * G * Ks + k;
  busy += c * S * Ks + k;
  realized += c * T * Ks + k;
  best += c * T * Ks + k;
  lat += c * n_samples * n_out * Ks + k;
  src_rate += k;
  g_frac += c * G;
  g_slot += c * G;
  hops += c * E;

  for (int step = 0; step < steps; ++step) {
    const bool in_window = step >= s0;
    for (int row = 0; row < T; ++row) {
      const int e0 = edge_off[row], e1 = edge_off[row + 1];
      double in_rate;
      if (e0 == e1) {
        in_rate = src_rate[row * Ks];
      } else {
        in_rate = 0.0;  // 0 + x is exact: numpy's first in-edge
        for (int e = e0; e < e1; ++e)
          in_rate = dadd(in_rate, dmul(realized[edge_src[e] * Ks], edge_mult[e]));
      }
      const int lo = row_off[row], hi = row_off[row + 1];
      if (lo == hi) {
        realized[row * Ks] = in_rate;
        continue;
      }
      double total = 0.0;
      for (int g = lo; g < hi; ++g) {
        const double cap = caps[g * Ks];
        const double arr = dmul(in_rate, g_frac[g]);
        const double q_len = dadd(queues[g * Ks], dmul(arr, dt));
        const double srv = fmin(q_len, dmul(cap, dt));
        queues[g * Ks] = dsub(q_len, srv);
        total = dadd(total, srv);
        if (in_window) {
          // groups in ascending order: np.add.at's order on each slot
          if (cap > 0.0) {
            double* b = busy + g_slot[g] * Ks;
            *b = dadd(*b, ddiv(srv, cap));
          }
          served_acc[g * Ks] = dadd(served_acc[g * Ks], srv);
        }
      }
      realized[row * Ks] = ddiv(total, dt);
    }
    if (step % sample_every != 0) continue;
    for (int row = 0; row < T; ++row) {
      double per_task = 0.0;
      for (int g = row_off[row]; g < row_off[row + 1]; ++g) {
        const double cap = caps[g * Ks];
        if (cap > 0.0)
          per_task = dadd(per_task, ddiv(dmul(g_frac[g], dadd(queues[g * Ks], 1.0)), cap));
      }
      const int e0 = edge_off[row], e1 = edge_off[row + 1];
      if (e0 == e1) {
        best[row * Ks] = per_task;
        continue;
      }
      double up = -CUDART_INF;
      for (int e = e0; e < e1; ++e) up = fmax(up, dadd(best[edge_src[e] * Ks], hops[e]));
      best[row * Ks] = dadd(per_task, up);
    }
    double* out = lat + static_cast<size_t>(step / sample_every) * n_out * Ks;
    for (int i = 0; i < n_out; ++i) {
      const int r0 = sink_off[i], r1 = sink_off[i + 1];
      double m = 0.0;
      if (r0 < r1) {
        m = best[sink_rows[r0] * Ks];
        for (int r = r0 + 1; r < r1; ++r) m = fmax(m, best[sink_rows[r] * Ks]);
      }
      out[i * Ks] = m;
    }
  }
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() (0 when the
// launch was taken).  Pointers are device pointers laid out as above.
extern "C" int repro_sweep_scan(const void* caps, const void* src_rate, const void* g_frac,
                                const void* g_slot, const void* hops, const void* row_off,
                                const void* edge_off, const void* edge_src,
                                const void* edge_mult, const void* sink_off,
                                const void* sink_rows, void* queues, void* busy, void* served,
                                void* realized, void* lat, void* best, int C, int T, int G,
                                int S, int n_out, int K, int n_samples, int steps,
                                int sample_every, int s0, double dt, int device,
                                void* stream) {
  if (C < 1 || T < 1 || G < 0 || S < 0 || n_out < 0 || K < 1 || steps < 0 ||
      sample_every < 1 || s0 < 0 || n_samples != (steps + sample_every - 1) / sample_every ||
      C > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = K >= kThreads ? kThreads : ((K + 31) / 32) * 32;
  const dim3 grid((K + threads - 1) / threads, C);
  sweep_scan_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(caps), static_cast<const double*>(src_rate),
      static_cast<const double*>(g_frac), static_cast<const int*>(g_slot),
      static_cast<const double*>(hops), static_cast<const int*>(row_off),
      static_cast<const int*>(edge_off), static_cast<const int*>(edge_src),
      static_cast<const double*>(edge_mult), static_cast<const int*>(sink_off),
      static_cast<const int*>(sink_rows), static_cast<double*>(queues),
      static_cast<double*>(busy), static_cast<double*>(served), static_cast<double*>(realized),
      static_cast<double*>(lat), static_cast<double*>(best), T, G, S, n_out, K, n_samples,
      steps, sample_every, s0, dt);
  return (int)cudaGetLastError();
}
