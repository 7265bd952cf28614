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
//   row_lag  (T)         row r's index within its segment: a run of rows
//                        that no later row's in-edge reaches back before
//                        (one DAG of a stacked fleet batch); lag_rows is
//                        the longest segment's rows
//   edge_off (T + 1)     in-edges of row r are edge_off[r] .. edge_off[r+1],
//   edge_src, edge_mult  each with its source row (an earlier row: rows are
//                        in topological order) and multiplier; the hop
//                        latency of edge e of candidate c is hops[c, e]
//   sink_off, sink_rows  the sink rows of each output (CSR; may be empty)
// Inputs caps (C, G, K), src_rate (T, K) shared by the candidates, g_frac
// (C, G), hops (C, E), and counts (C, T): candidate c's real groups of row
// r are the first counts[c, r] of the row's span (the rest are a search
// bucket's padding and are never touched).  slot_off (C, S + 1) and
// slot_grp (C, G) list each slot's real groups in ascending group order (a
// stable sort of g_slot, built by the wrapper).  Outputs queues and served
// (C, G, K), busy (C, S, K), realized (C, T, K) and lat (C, n_samples,
// n_out, K) are written whole by the kernel.
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
// `_sweep_numpy`), so the two agree to the last bit: sums run in edge order
// and group order, the busy scatter tick by tick in each slot's ascending
// group order (np.add.at's), and every product and sum is rounded on its
// own (__dmul_rn / __dadd_rn) where numpy rounds twice, so nvcc cannot
// contract it into an FMA.  Every ordered sum is one lane walking its
// values in order, never a tree.  Padded groups are skipped, which is
// exact: a padded group (cap = frac = 0) adds +0.0 everywhere.
//
// Design: one warp per (candidate, rate column), up to kMaxWarps warps a
// block, all of one candidate (blockIdx.y = c).
//   * Row r at tick t needs only row r at tick t - 1 (its queues) and its
//     upstream rows at tick t, all in its own segment.  So rows run as a
//     wavefront: lane r % 32 runs row r, `skew` * lag ticks behind its
//     segment's first row (lag = row_lag[r]), and in wave w every lane
//     advances its row by one tick (t = w - skew lag), walking the row's
//     in-edges and groups in order.  A sweep of `steps` ticks takes
//     steps + skew (TL - 1) waves of one row each (TL = lag_rows), where a
//     tick done row by row takes T rows in sequence; a fleet's DAGs run
//     side by side, each lagged from its own first row.  With skew =
//     sample_every every row samples the path latency in the same waves,
//     so the warp pays for the sample terms in one wave of sample_every,
//     not in every wave; the wrapper takes skew 1 where the deeper rings
//     that needs do not fit.
//   * Realized rates pass between rows through a ring indexed by tick
//     (depth DR, the least power of two > skew (TL - 1): a value is read
//     at most skew (TL - 1) waves after it is written), the path latency of
//     each row through a ring indexed by sample (depth DB, the least power
//     of two >= TL).  Busy terms served / cap wait in a DR-deep ring too,
//     placed in slot order, until the wave in which the deepest row of
//     every segment has finished their tick (wave tb + skew (TL - 1)); then
//     lanes over slots add them in group order, across the whole slot
//     pool.  An output's latency sample is written in the wave its deepest
//     sink row samples.
//   * The whole state (queues, served_acc, busy, caps, their reciprocals
//     and cap dt, the rings) is private to its warp for the whole launch;
//     the candidate's placement and the structure (a 16-byte descriptor per
//     row and per in-edge) are staged once per block.  Placement 0 keeps
//     the block's whole layout in shared memory.  Where one column's does
//     not fit in the 227 KB a block can have (a fleet far past a dozen
//     DAGs, or thousands of groups), placement 1 lays out the same bytes in
//     a device-memory scratch of the wrapper's, one stride per block, and
//     the kernel runs unchanged on them.  Device memory is otherwise read
//     once at the start and written once at the end, the latency samples
//     as they are made.
//   * Divisions by dt and by a cap use the divisor's reciprocal rounded once
//     and two exact FMA corrections, which round the quotient correctly
//     (Markstein), in 5 dependent operations instead of the hardware
//     sequence's ~15; min and max are compares and selects.
//
// Bound on an H100 SXM: bytes and float64 operations are both microseconds
// at the paper's sizes.  What bounds the kernel is the dependent chain of a
// wave, set by the row with the most groups and in-edges (plus the busy
// walk of the slot with the most groups), times steps + skew (T - 1) waves.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kMaxWarps = 4;
constexpr int kMaxShared = 232448;   // 227 KB: the most a block can have

__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
// Out of line: the hardware division sequence is long, and it is the rare
// path of div_by.
__device__ __noinline__ double ddiv(double a, double b) { return __ddiv_rn(a, b); }
// np.minimum / np.maximum of numbers (no NaN reaches them)
__device__ __forceinline__ double dmin(double a, double b) { return a < b ? a : b; }
__device__ __forceinline__ double dmax(double a, double b) { return a > b ? a : b; }

// RN(1/b) where div_by may use it (b well inside the normal range), else 0.
__device__ __forceinline__ double recip(double b) {
  return b > 0x1p-60 && b < 0x1p60 ? __drcp_rn(b) : 0.0;
}

// a / b rounded once, from y = recip(b): q = RN(a y), then twice
// q += (a - b q) y with the remainder an exact FMA.  After the first
// correction q is faithful, so the second rounds it correctly (Markstein's
// theorem).  That needs a, b and a / b well inside the normal range; other
// operands (y = 0 for b) go to the hardware sequence.
__device__ __forceinline__ double div_by(double a, double b, double y) {
  const double m = fabs(a);
  if (y == 0.0 || (m != 0.0 && !(m > 0x1p-900 && m < 0x1p900))) return ddiv(a, b);
  double q = dmul(a, y);
  double r = __fma_rn(-b, q, a);
  q = __fma_rn(r, y, q);
  r = __fma_rn(-b, q, a);
  return __fma_rn(r, y, q);
}

// A task row: its first group, its real groups (-1: the span is empty, the
// row passes its in-rate on), its in-edges e0 .. e1.
struct __align__(16) Row {
  int lo, n, e0, e1;
};

// An in-edge: multiplier, source row; the hop latency is per candidate.
struct __align__(16) Edge {
  double mult;
  int src, pad;
};

// The least power of two >= n: the depth of a ring of n entries.
__host__ __device__ inline int ring_depth(int n) {
  int d = 1;
  while (d < n) d <<= 1;
  return d;
}

// Doubles a warp keeps: queue, served_acc, cap, its reciprocal, cap dt (G
// each), src_rate (T), busy (S), the realized ring (T x DR), the busy-term
// ring (L x DR; L: the most real groups of a candidate) and the latency
// ring (T x DB), DR = ring_depth(skew (TL - 1) + 1), DB = ring_depth(TL).
__host__ __device__ inline long long warp_doubles(int G, int S, int T, int L, int skew,
                                                  int TL) {
  const long long DR = ring_depth(skew * (TL - 1) + 1), DB = ring_depth(TL);
  return 5LL * G + T + S + (1LL * T + L) * DR + 1LL * T * DB;
}

// Bytes of a block's layout of `warps` warps: rows (T) and edges (E) at 16
// bytes, the block's doubles (g_frac G, hops E), every warp's state, then
// the ints (slot_off S + 1, each group's place in slot order G, sink_off
// n_out + 1, sink_rows n_sink, each output's deepest sink lag n_out, each
// row's lag T).  kernel.py::shared_bytes computes the same.
__host__ __device__ inline long long shared_bytes(int G, int S, int T, int E, int n_out,
                                                  int n_sink, int L, int skew, int warps,
                                                  int TL) {
  return 16LL * (T + E) + 8LL * (G + E) + 8LL * warps * warp_doubles(G, S, T, L, skew, TL) +
         4LL * (S + 1 + G + 2LL * n_out + 1 + n_sink + T);
}

// kScratch false: the layout in dynamic shared memory (placement 0); true:
// in this block's stride of the device scratch (placement 1).  Two
// instantiations of one body, so that the shared one addresses shared
// memory directly.
template <bool kScratch>
__global__ void __launch_bounds__(kMaxWarps * 32)
    sweep_wave_kernel(const double* __restrict__ caps, const double* __restrict__ src_rate,
                      const double* __restrict__ g_frac, const double* __restrict__ hops,
                      const int* __restrict__ counts, const int* __restrict__ slot_off,
                      const int* __restrict__ slot_grp, const int* __restrict__ row_off,
                      const int* __restrict__ row_lag,
                      const int* __restrict__ edge_off, const int* __restrict__ edge_src,
                      const double* __restrict__ edge_mult, const int* __restrict__ sink_off,
                      const int* __restrict__ sink_rows, double* __restrict__ queues,
                      double* __restrict__ busy, double* __restrict__ served,
                      double* __restrict__ realized, double* __restrict__ lat,
                      unsigned char* __restrict__ scratch, long long stride, int T, int G,
                      int S, int E, int n_out, int n_sink, int L, int K, int n_samples,
                      int steps, int sample_every, int s0, int skew, int TL, double dt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t c = blockIdx.y;
  const int k = blockIdx.x * warps + warp;
  const size_t Ks = static_cast<size_t>(K);
  const int DR = ring_depth(skew * (TL - 1) + 1), MR = DR - 1;
  const int DB = ring_depth(TL), MB = DB - 1;

  // carve: rows, edges, the block's doubles, the warps' doubles, the ints;
  // in shared memory, or in this block's stride of the device scratch
  unsigned char* base =
      kScratch ? scratch + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * stride
               : smem;
  Row* rows = reinterpret_cast<Row*>(base);
  Edge* edges = reinterpret_cast<Edge*>(rows + T);
  double* frac = reinterpret_cast<double*>(edges + E);
  double* hop = frac + G;
  const long long wd = warp_doubles(G, S, T, L, skew, TL);
  double* queue = hop + E + warp * wd;
  double* acc = queue + G;          // served within the window
  double* cap = acc + G;            // 0 for padded groups
  double* rcap = cap + G;           // recip(cap)
  double* capdt = rcap + G;
  double* src = capdt + G;
  double* bsy = src + T;
  double* ring_r = bsy + S;          // realized of row r at tick t: [r * DR + t % DR]
  double* ring_x = ring_r + T * DR;  // busy term of slot-order place i: [i * DR + t % DR]
  double* ring_b = ring_x + L * DR;  // best of row r at sample n: [r * DB + n % DB]
  int* s_off = reinterpret_cast<int*>(hop + E + warps * wd);
  int* pos = s_off + S + 1;         // group g's place in slot order, -1 if padded
  int* k_off = pos + G;
  int* k_rows = k_off + n_out + 1;
  int* k_last = k_rows + n_sink;    // each output's deepest sink lag (0 with none)
  int* lag = k_last + n_out;        // each row's lag in its segment

  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    const int lo = row_off[i];
    rows[i] = Row{lo, row_off[i + 1] > lo ? counts[c * T + i] : -1, edge_off[i],
                  edge_off[i + 1]};
    lag[i] = row_lag[i];
  }
  for (int i = threadIdx.x; i < E; i += blockDim.x) {
    edges[i] = Edge{edge_mult[i], edge_src[i], 0};
    hop[i] = hops[c * E + i];
  }
  for (int i = threadIdx.x; i < G; i += blockDim.x) {
    frac[i] = g_frac[c * G + i];
    pos[i] = -1;
  }
  for (int i = threadIdx.x; i <= S; i += blockDim.x) s_off[i] = slot_off[c * (S + 1) + i];
  for (int i = threadIdx.x; i <= n_out; i += blockDim.x) k_off[i] = sink_off[i];
  for (int i = threadIdx.x; i < n_sink; i += blockDim.x) k_rows[i] = sink_rows[i];
  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    int last = 0;
    for (int j = sink_off[i]; j < sink_off[i + 1]; ++j) last = max(last, row_lag[sink_rows[j]]);
    k_last[i] = last;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s_off[S]; i += blockDim.x) pos[slot_grp[c * G + i]] = i;
  __syncthreads();   // the last block barrier: spare warps leave after it
  if (k >= K) return;

  // this warp's column: caps (padded groups read as 0), zeroed state; the
  // rings need none, each value is written before it is read
  for (int row = 0; row < T; ++row) {
    const int lo = row_off[row], n = counts[c * T + row];
    for (int g = lo + lane; g < row_off[row + 1]; g += 32) {
      const double cp = g - lo < n ? caps[(c * G + g) * Ks + k] : 0.0;
      cap[g] = cp;
      rcap[g] = recip(cp);
      capdt[g] = dmul(cp, dt);
      queue[g] = 0.0;
      acc[g] = 0.0;
    }
  }
  for (int s = lane; s < S; s += 32) bsy[s] = 0.0;
  for (int r = lane; r < T; r += 32) src[r] = src_rate[r * Ks + k];
  const double rdt = recip(dt);
  __syncwarp();

  const int waves = steps > 0 ? steps + skew * (TL - 1) : 0;
  for (int w = 0; w < waves; ++w) {
    // each lane advances its rows by one tick
    for (int row = lane; row < T; row += 32) {
      const int t = w - skew * lag[row];
      if (t < 0 || t >= steps) continue;
      const Row r = rows[row];
      const int at = t & MR;
      double rate;
      if (r.e0 == r.e1) {
        rate = src[row];
      } else {
        rate = 0.0;   // numpy's 0 + first in-edge
        for (int e = r.e0; e < r.e1; ++e) {
          const Edge ed = edges[e];
          rate = dadd(rate, dmul(ring_r[ed.src * DR + at], ed.mult));
        }
      }
      const bool in_window = t >= s0;
      const bool sample = t % sample_every == 0;
      double per_task = 0.0;
      if (r.n >= 0) {
        double total = 0.0;
        for (int g = r.lo; g < r.lo + r.n; ++g) {
          const double q_len = dadd(queue[g], dmul(dmul(rate, frac[g]), dt));
          const double srv = dmin(q_len, capdt[g]);
          const double q_new = dsub(q_len, srv);
          queue[g] = q_new;
          total = dadd(total, srv);
          const double cp = cap[g];
          if (in_window) {
            acc[g] = dadd(acc[g], srv);
            // nothing where cap <= 0: + 0 leaves the busy sum as it is
            ring_x[pos[g] * DR + at] = cp > 0.0 ? div_by(srv, cp, rcap[g]) : 0.0;
          }
          if (sample && cp > 0.0)
            per_task = dadd(per_task, div_by(dmul(frac[g], dadd(q_new, 1.0)), cp, rcap[g]));
        }
        rate = div_by(total, dt, rdt);
      }
      ring_r[row * DR + at] = rate;
      if (sample) {
        const int n_at = (t / sample_every) & MB;
        double best = per_task;
        if (r.e0 < r.e1) {
          double up = -CUDART_INF;
          for (int e = r.e0; e < r.e1; ++e)
            up = dmax(up, dadd(ring_b[edges[e].src * DB + n_at], hop[e]));
          best = dadd(per_task, up);
        }
        ring_b[row * DB + n_at] = best;
      }
    }
    __syncwarp();
    // the busy terms of the tick every segment's deepest row has just
    // finished, lane per slot, its groups in ascending order: np.add.at's
    const int tb = w - skew * (TL - 1);
    if (tb >= s0 && tb >= 0) {
      const int at = tb & MR;
      for (int s = lane; s < S; s += 32) {
        double b = bsy[s];
        for (int i = s_off[s]; i < s_off[s + 1]; ++i) b = dadd(b, ring_x[i * DR + at]);
        bsy[s] = b;
      }
    }
    // the latency samples whose deepest sink row has just sampled
    for (int i = lane; i < n_out; i += 32) {
      const int t = w - skew * k_last[i];
      if (t < 0 || t >= steps || t % sample_every != 0) continue;
      const int n_at = (t / sample_every) & MB;
      const int r0 = k_off[i], r1 = k_off[i + 1];
      double m = 0.0;
      if (r0 < r1) {
        m = ring_b[k_rows[r0] * DB + n_at];
        for (int j = r0 + 1; j < r1; ++j) m = dmax(m, ring_b[k_rows[j] * DB + n_at]);
      }
      lat[((c * n_samples + t / sample_every) * n_out + i) * Ks + k] = m;
    }
    __syncwarp();
  }

  for (int g = lane; g < G; g += 32) {
    queues[(c * G + g) * Ks + k] = queue[g];
    served[(c * G + g) * Ks + k] = acc[g];
  }
  for (int s = lane; s < S; s += 32) busy[(c * S + s) * Ks + k] = bsy[s];
  for (int r = lane; r < T; r += 32)
    realized[(c * T + r) * Ks + k] = steps > 0 ? ring_r[r * DR + ((steps - 1) & MR)] : 0.0;
}

}  // namespace

// Launches the sweep on `stream` and returns cudaGetLastError() (0 when the
// launch was taken).  Pointers are device pointers laid out as above;
// `warps` (1..4), `skew`, `placement` and `nbytes` are the wrapper's launch
// shape: nbytes must equal shared_bytes() here.  Placement 0 takes nbytes
// of dynamic shared memory (at most 227 KB); placement 1 takes none and
// lays each block out in its stride (nbytes rounded up to 16) of `scratch`,
// which holds C x ceil(K / warps) strides.  L is the most real groups of a
// candidate, lag_rows the longest segment's rows.
extern "C" int repro_sweep_scan(const void* caps, const void* src_rate, const void* g_frac,
                                const void* hops, const void* counts, const void* slot_off,
                                const void* slot_grp, const void* row_off, const void* row_lag,
                                const void* edge_off, const void* edge_src,
                                const void* edge_mult, const void* sink_off,
                                const void* sink_rows, void* queues, void* busy, void* served,
                                void* realized, void* lat, void* scratch, int C, int T, int G,
                                int S, int E, int n_out, int n_sink, int L, int K,
                                int n_samples, int steps, int sample_every, int s0, int skew,
                                int lag_rows, int warps, int placement, long long nbytes,
                                double dt, int device, void* stream) {
  if (C < 1 || T < 1 || G < 0 || S < 0 || E < 0 || n_out < 0 || n_sink < 0 || L < 0 ||
      L > G || K < 1 || steps < 0 || sample_every < 1 || s0 < 0 ||
      n_samples != (steps + sample_every - 1) / sample_every || C > 65535 || skew < 1 ||
      lag_rows < 1 || lag_rows > T || warps < 1 || warps > kMaxWarps ||
      (placement == 0 && nbytes > kMaxShared) ||
      (placement == 1 && scratch == nullptr) || placement < 0 || placement > 1 ||
      nbytes != shared_bytes(G, S, T, E, n_out, n_sink, L, skew, warps, lag_rows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int shared = placement == 0 ? static_cast<int>(nbytes) : 0;
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(sweep_wave_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((K + warps - 1) / warps, C);
  auto* kernel = placement == 1 ? sweep_wave_kernel<true> : sweep_wave_kernel<false>;
  kernel<<<grid, warps * 32, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(caps), static_cast<const double*>(src_rate),
      static_cast<const double*>(g_frac), static_cast<const double*>(hops),
      static_cast<const int*>(counts), static_cast<const int*>(slot_off),
      static_cast<const int*>(slot_grp), static_cast<const int*>(row_off),
      static_cast<const int*>(row_lag), static_cast<const int*>(edge_off),
      static_cast<const int*>(edge_src), static_cast<const double*>(edge_mult),
      static_cast<const int*>(sink_off), static_cast<const int*>(sink_rows),
      static_cast<double*>(queues), static_cast<double*>(busy), static_cast<double*>(served),
      static_cast<double*>(realized), static_cast<double*>(lat),
      static_cast<unsigned char*>(scratch), (nbytes + 15) / 16 * 16,
      T, G, S, E, n_out, n_sink, L, K, n_samples, steps, sample_every, s0, skew, lag_rows, dt);
  return (int)cudaGetLastError();
}
