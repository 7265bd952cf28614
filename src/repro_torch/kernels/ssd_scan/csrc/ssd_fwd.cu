// Mamba2 chunked SSD scan forward for Hopper (sm_90a): bf16 on the tensor
// cores (mma.sync), fp32 on scalar FP32 FMA.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (launched by ssd_scan_fwd through pl.pallas_call).  Same function, in the
// model layout: x (Bt, S, H, P) and B/C (Bt, S, G, N) in the compute type
// (fp32 or bf16), dt (Bt, S, H) and A (H,) in fp32, optional init_state
// (Bt, H, P, N) fp32.  B and C come in G groups, each shared by H / G
// consecutive heads: head h reads group h / (H / G).  G = 1 is the TPU
// kernel's one group, (Bt, S, N); G = 8 is Nemotron-H's Mamba2.  The
// sequence is cut into chunks of Q positions (the last one may be
// shorter: the TPU kernel pads it with dt = 0, which adds nothing, so here
// it is simply masked).  Per (b, h) and chunk, with
// cum = cumsum(dt * A) inside the chunk:
//   y_i     = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) (C_i . state_in)
//   state  <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// y is written in x's type, the final state (Bt, H, P, N) in fp32.
//
// Structure, both types.  The TPU kernel runs the grid (Bt, H, chunks) in
// order and carries the (P, N) state in VMEM scratch from chunk to chunk.
// Hopper runs blocks in no order, so the carried state becomes a pass of its
// own and the heavy work runs in parallel over chunks:
//   1. chunk state, one block per (chunk, h, b): the chunk's cum (a
//      block-wide scan; written out for passes 2 and 3) and its state
//      summary sum_j w_j x_j B_j^T, w_j = exp(cum_last - cum_j) dt_j, into a
//      (Bt, H, chunks, P, N) fp32 scratch;
//   2. state_scan_kernel, one thread per (b, h, p, n): walks the chunks in
//      order, replaces each summary with the state entering that chunk, and
//      writes the final state;
//   3. chunk out, one block per (chunk, 64-row tile of the chunk, b) and
//      heads: the masked decay "attention" over the tile's columns up to the
//      diagonal plus the entering state's term, written once as y.
// Every kernel reads a head's group from its own block indices (no launch
// per group): the rows of B and C are G * N apart, and a pass-3 block's
// heads all lie in one group.  Each kernel is instantiated twice: Grouped
// false is the one-group code, every group index a constant 0, which the
// reference's models run; true reads G.
// Nothing of size Q x Q is ever held: each 64 x 64 block of
// (C_i . B_j) exp(cum_i - cum_j) dt_j is built from cum for one (row tile,
// column tile <= row tile) at a time, the mask applied before exp, and tiles
// above the diagonal are skipped.
//
// Bound on an H100 SXM (datasheet: 989e12 bf16 FLOP/s dense on the tensor
// cores, 3.35e12 B/s HBM3): max(flops / 989e12, bytes / 3.35e12).  The least
// work at the mamba2-370m serving shape (Bt=1, S=1024, Q=256, H=32, P=64,
// N=128) is ~1.5 GFLOP (C.B^T once per chunk and shared by the heads, the
// causal half of it, then per head the attention-times-x, the state term and
// the summary), ~1.5 us; the bytes are |x| + |y| + |B| + |C| + |dt| + |final
// state| ~ 10.1 MB, ~3.0 us: the bound is bytes.
//
// bf16 (chunk_state_tc_kernel, chunk_out_tc_kernel), against the limits of
// the first, scalar design (fp32 FMA only, C.B^T recomputed for every head,
// synchronous scalar staging, 128 registers and a spill in pass 3):
//   - pass 3 owns a group of kHeadsTc = 4 heads per block of 16 warps (4 row
//     warps per head): C_i . B_j^T is one 64 x 64 mma.sync product per column
//     tile, written once to shared memory and reused by every head of the
//     group (B and C are shared by the heads); per head, att = CB *
//     exp(cum_i - cum_j) * dt_j is formed in fp32 registers (ex2.approx, the
//     mask applied as -inf before it), packed to bf16 as the A fragment of
//     att . x_j (x_j by ldmatrix.trans); the entering states are rounded to
//     bf16 in shared memory and C_i . state^T runs on mma.sync too.  C_i, B_j,
//     the group's x_j, cum_j and dt_j are staged by cp.async, in a two-stage
//     ring, so the next column tile loads while this one is computed;
//   - pass 1 runs x^T (w B) on mma.sync, x and B staged by cp.async in a
//     two-stage ring: x is exact in bf16, w B is fp32 and
//     is split into a bf16 high part and the bf16 rounding of the rest (two
//     products), because one bf16 rounding of w B puts ~1e-3 relative error
//     on each summary element, which the reference's state tolerance (1e-3
//     abs + rel) does not hold at the tails of ~262k elements;
//   - all shared rows are padded by 16 bytes so that ldmatrix's row
//     addresses fall in distinct bank groups.
// The tensor-core path needs P and N multiples of 16, P <= 64, N <= 256 and
// 16-byte aligned x, B, C; the wrapper checks and raises.
//
// fp32 (chunk_state_kernel, chunk_out_kernel) keeps the scalar IEEE FMA
// design: the fp32 path is held to 1e-4 against the plain version, which
// neither bf16 nor TF32 products can meet.  Tiles are staged through shared
// memory as fp32 and each of the 256 threads owns a 4 x 4 block of outputs.
//
// Left for later: wgmma, TMA with mbarriers, warp specialisation, and pass 2
// fused into pass 1 where the chunk count is small.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // positions per tile
constexpr int kLdT = kTile + 4;    // row stride of a tile kept with positions contiguous
constexpr int kMaxP = 64;
constexpr int kPL = kMaxP / 16;  // output columns per thread: tx + 16l, l < kPL
constexpr int kMaxN = 256;
constexpr int kMaxQ = 4096;

// the scalar passes run for fp32 only
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }

// Row stride, in floats, of rows of n values read as float4: a multiple of 4
// holding an odd number of float4s, so 8 neighbouring rows hit distinct
// banks.
__host__ __device__ __forceinline__ int row_stride(int n) { return ((n + 7) / 8) * 8 + 4; }

__device__ __forceinline__ float dot4(const float4 a, const float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
  return acc;
}

// Inclusive cumsum of dt * A over the L positions of one chunk into
// s_cum[0, L).  dt points at the chunk's first position of this (b, h);
// positions are H floats apart.  Every thread of the block must call it.
__device__ void chunk_cumsum(const float* __restrict__ dt, int H, float A, int L,
                             float* __restrict__ s_cum, float* __restrict__ s_warp,
                             float* __restrict__ s_carry) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < L; base += kThreads) {
    const int t = base + tid;
    float v = t < L ? dt[(size_t)t * H] * A : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) s_warp[warp] = v;
    __syncthreads();
    float prefix = carry;
    for (int w = 0; w < warp; ++w) prefix += s_warp[w];
    v += prefix;
    if (t < L) s_cum[t] = v;
    if (tid == kThreads - 1) *s_carry = v;
    __syncthreads();
    carry = *s_carry;
    __syncthreads();  // s_warp and s_carry are rewritten by the next segment
  }
}

// Pass 1.  grid (chunks, H, Bt).  Shared memory: cum[Q rounded to 4],
// w[64], xT[kMaxP][kLdT], wBT[64][kLdT].
template <typename T, bool Grouped>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ cum, float* __restrict__ states, int S,
                   int H, int P, int N, int G, int Q) {
  extern __shared__ float4 smem4[];
  float* s_cum = reinterpret_cast<float*>(smem4);
  float* s_w = s_cum + ((Q + 3) & ~3);
  float* s_xT = s_w + kTile;
  float* s_wbT = s_xT + kMaxP * kLdT;
  __shared__ float s_warp[kWarps];
  __shared__ float s_carry;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int L = min(Q, S - s0);
  const float a = A[h];

  chunk_cumsum(dt + ((size_t)b * S + s0) * H + h, H, a, L, s_cum, s_warp, &s_carry);
  float* cum_bh = cum + ((size_t)b * H + h) * S + s0;
  for (int t = tid; t < L; t += kThreads) cum_bh[t] = s_cum[t];
  const float cum_last = s_cum[L - 1];

  const size_t ldbc = Grouped ? (size_t)G * N : (size_t)N;  // B/C row stride
  const T* xb = x + ((size_t)b * S + s0) * H * P + (size_t)h * P;
  const T* bb = Bm + ((size_t)b * S + s0) * ldbc + (Grouped ? (size_t)(h / (H / G)) * N : 0);
  const float* dtb = dt + ((size_t)b * S + s0) * H + h;
  float* out = states + (((size_t)b * H + h) * nc + c) * P * N;

  for (int n0 = 0; n0 < N; n0 += kTile) {
    float acc[kPL][4];
#pragma unroll
    for (int k = 0; k < kPL; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) acc[k][l] = 0.f;

    for (int j0 = 0; j0 < L; j0 += kTile) {
      const int rj = min(kTile, L - j0);
      __syncthreads();  // the previous tile is consumed
      if (tid < kTile) {
        const int j = j0 + tid;
        s_w[tid] = tid < rj ? expf(cum_last - s_cum[j]) * dtb[(size_t)j * H] : 0.f;
      }
      for (int i = tid; i < kTile * kMaxP; i += kThreads) {
        const int jj = i / kMaxP;
        const int p = i % kMaxP;
        s_xT[p * kLdT + jj] = (jj < rj && p < P) ? to_f(xb[(size_t)(j0 + jj) * H * P + p]) : 0.f;
      }
      __syncthreads();  // s_w is ready
      for (int i = tid; i < kTile * kTile; i += kThreads) {
        const int jj = i / kTile;
        const int nn = i % kTile;
        const int n = n0 + nn;
        s_wbT[nn * kLdT + jj] =
            (jj < rj && n < N) ? to_f(bb[(size_t)(j0 + jj) * ldbc + n]) * s_w[jj] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kTile; jj += 4) {
        float4 xv[kPL], wv[4];
#pragma unroll
        for (int k = 0; k < kPL; ++k)
          xv[k] = *reinterpret_cast<const float4*>(s_xT + (ty + 16 * k) * kLdT + jj);
#pragma unroll
        for (int l = 0; l < 4; ++l)
          wv[l] = *reinterpret_cast<const float4*>(s_wbT + (tx + 16 * l) * kLdT + jj);
#pragma unroll
        for (int k = 0; k < kPL; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) acc[k][l] = dot4(xv[k], wv[l], acc[k][l]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPL; ++k) {
      const int p = ty + 16 * k;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int n = n0 + tx + 16 * l;
        if (p < P && n < N) out[(size_t)p * N + n] = acc[k][l];
      }
    }
  }
}

// Pass 2.  grid (ceil(P*N / 256), H, Bt).  states holds each chunk's
// summary on entry and the state entering each chunk on exit.
__global__ void __launch_bounds__(kThreads)
state_scan_kernel(float* __restrict__ states, const float* __restrict__ cum,
                  const float* __restrict__ init_state, float* __restrict__ final_state,
                  int S, int H, int P, int N, int Q, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int PN = P * N;
  if (e >= PN) return;
  const size_t bh = (size_t)b * H + h;
  float s = init_state ? init_state[bh * PN + e] : 0.f;
  const float* cum_bh = cum + bh * S;
  for (int c = 0; c < nc; ++c) {
    const size_t idx = (bh * nc + c) * PN + e;
    const float summary = states[idx];
    states[idx] = s;
    const float decay = expf(cum_bh[min(c * Q + Q, S) - 1]);
    s = __fadd_rn(__fmul_rn(decay, s), summary);
  }
  final_state[bh * PN + e] = s;
}

// Pass 3.  grid (chunks, H, row tiles * Bt), the heaviest row tiles first.
// Shared memory: C[64][LDC], B[64][LDC] (then the entering state
// [kMaxP][LDC]), xT[kMaxP][kLdT], att[64][kLdT], cum_i[64], cum_j[64],
// dt_j[64].
template <typename T, bool Grouped>
__global__ void __launch_bounds__(kThreads)
chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ cum, const float* __restrict__ states,
                 T* __restrict__ y, int Bt, int S, int H, int P, int N, int G, int Q) {
  const int LDC = row_stride(N);
  const int Npad = (N + 3) & ~3;
  extern __shared__ float4 smem4[];
  float* s_c = reinterpret_cast<float*>(smem4);
  float* s_b = s_c + kTile * LDC;
  float* s_xT = s_b + kTile * LDC;
  float* s_att = s_xT + kMaxP * kLdT;
  float* s_cum_i = s_att + kTile * kLdT;
  float* s_cum_j = s_cum_i + kTile;
  float* s_dt_j = s_cum_j + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int n_it = (Q + kTile - 1) / kTile;
  const int it = n_it - 1 - blockIdx.z / Bt;
  const int b = blockIdx.z % Bt;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int L = min(Q, S - s0);
  const int i0 = it * kTile;
  if (i0 >= L) return;
  const int ri = min(kTile, L - i0);

  const size_t ldbc = Grouped ? (size_t)G * N : (size_t)N;  // B/C row stride
  const size_t gofs = Grouped ? (size_t)(h / (H / G)) * N : 0;
  const T* xb = x + ((size_t)b * S + s0) * H * P + (size_t)h * P;
  const T* bb = Bm + ((size_t)b * S + s0) * ldbc + gofs;
  const T* cb = Cm + ((size_t)b * S + s0) * ldbc + gofs;
  const float* dtb = dt + ((size_t)b * S + s0) * H + h;
  const float* cum_bh = cum + ((size_t)b * H + h) * S + s0;

  for (int i = tid; i < kTile * Npad; i += kThreads) {
    const int r = i / Npad;
    const int n = i % Npad;
    s_c[r * LDC + n] = (r < ri && n < N) ? to_f(cb[(size_t)(i0 + r) * ldbc + n]) : 0.f;
  }
  if (tid < kTile) s_cum_i[tid] = tid < ri ? cum_bh[i0 + tid] : 0.f;

  float acc[4][kPL];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < kPL; ++l) acc[k][l] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kTile;
    const int rj = min(kTile, L - j0);
    __syncthreads();  // the previous tile is consumed (and s_c is staged)
    for (int i = tid; i < kTile * Npad; i += kThreads) {
      const int r = i / Npad;
      const int n = i % Npad;
      s_b[r * LDC + n] = (r < rj && n < N) ? to_f(bb[(size_t)(j0 + r) * ldbc + n]) : 0.f;
    }
    for (int i = tid; i < kTile * kMaxP; i += kThreads) {
      const int jj = i / kMaxP;
      const int p = i % kMaxP;
      s_xT[p * kLdT + jj] = (jj < rj && p < P) ? to_f(xb[(size_t)(j0 + jj) * H * P + p]) : 0.f;
    }
    if (tid < kTile) {
      s_cum_j[tid] = tid < rj ? cum_bh[j0 + tid] : 0.f;
      s_dt_j[tid] = tid < rj ? dtb[(size_t)(j0 + tid) * H] : 0.f;
    }
    __syncthreads();

    // scores C_i . B_j for this thread's 4 x 4 block of the tile
    float s[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = 0; l < 4; ++l) s[k][l] = 0.f;
#pragma unroll 2
    for (int n = 0; n < Npad; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cv[k] = *reinterpret_cast<const float4*>(s_c + (ty + 16 * k) * LDC + n);
#pragma unroll
      for (int l = 0; l < 4; ++l)
        bv[l] = *reinterpret_cast<const float4*>(s_b + (tx + 16 * l) * LDC + n);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < 4; ++l) s[k][l] = dot4(cv[k], bv[l], s[k][l]);
    }
    // (scores * L) * dt_j, L masked to j <= i before the exp
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = ty + 16 * k;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int col = tx + 16 * l;
        const bool ok = (j0 + col <= i0 + r) && col < rj && r < ri;
        const float decay = ok ? expf(s_cum_i[r] - s_cum_j[col]) : 0.f;
        s_att[r * kLdT + col] = __fmul_rn(__fmul_rn(s[k][l], decay), s_dt_j[col]);
      }
    }
    __syncthreads();

    // acc += att . x over the tile's columns
#pragma unroll 4
    for (int jj = 0; jj < kTile; jj += 4) {
      float4 av[4], xv[kPL];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        av[k] = *reinterpret_cast<const float4*>(s_att + (ty + 16 * k) * kLdT + jj);
#pragma unroll
      for (int l = 0; l < kPL; ++l)
        xv[l] = *reinterpret_cast<const float4*>(s_xT + (tx + 16 * l) * kLdT + jj);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int l = 0; l < kPL; ++l) acc[k][l] = dot4(av[k], xv[l], acc[k][l]);
    }
  }

  // the entering state's term: exp(cum_i) * (C_i . state_in), state_in in s_b
  __syncthreads();
  const float* st = states + (((size_t)b * H + h) * nc + c) * P * N;
  for (int i = tid; i < kMaxP * Npad; i += kThreads) {
    const int p = i / Npad;
    const int n = i % Npad;
    s_b[p * LDC + n] = (p < P && n < N) ? st[(size_t)p * N + n] : 0.f;
  }
  __syncthreads();
  float inter[4][kPL];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int l = 0; l < kPL; ++l) inter[k][l] = 0.f;
#pragma unroll 2
  for (int n = 0; n < Npad; n += 4) {
    float4 cv[4], sv[kPL];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      cv[k] = *reinterpret_cast<const float4*>(s_c + (ty + 16 * k) * LDC + n);
#pragma unroll
    for (int l = 0; l < kPL; ++l)
      sv[l] = *reinterpret_cast<const float4*>(s_b + (tx + 16 * l) * LDC + n);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = 0; l < kPL; ++l) inter[k][l] = dot4(cv[k], sv[l], inter[k][l]);
  }

  T* yb = y + ((size_t)b * S + s0 + i0) * H * P + (size_t)h * P;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = ty + 16 * k;
    if (r >= ri) continue;
    const float e = expf(s_cum_i[r]);
#pragma unroll
    for (int l = 0; l < kPL; ++l) {
      const int p = tx + 16 * l;
      if (p < P) store_as(yb + (size_t)r * H * P + p, __fadd_rn(acc[k][l], __fmul_rn(inter[k][l], e)));
    }
  }
}

template <typename T, bool Grouped>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* init_state, void* y, float* final_state,
                   float* cum, float* states, int Bt, int S, int H, int P, int N, int G,
                   int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int n_it = (Q + kTile - 1) / kTile;
  const int LDC = row_stride(N);

  const size_t smem1 = sizeof(float) * (size_t)(((Q + 3) & ~3) + kTile + kMaxP * kLdT + kTile * kLdT);
  cudaError_t err = cudaFuncSetAttribute(chunk_state_kernel<T, Grouped>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<T, Grouped><<<dim3(nc, H, Bt), kThreads, smem1, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), cum, states, S, H, P, N, G, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  state_scan_kernel<<<dim3((P * N + kThreads - 1) / kThreads, H, Bt), kThreads, 0, stream>>>(
      states, cum, init_state, final_state, S, H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem3 =
      sizeof(float) * (size_t)(2 * kTile * LDC + kMaxP * kLdT + kTile * kLdT + 3 * kTile);
  err = cudaFuncSetAttribute(chunk_out_kernel<T, Grouped>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  chunk_out_kernel<T, Grouped><<<dim3(nc, H, n_it * Bt), kThreads, smem3, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(Bm), static_cast<const T*>(Cm), cum,
      states, static_cast<T*>(y), Bt, S, H, P, N, G, Q);
  return cudaGetLastError();
}


// ---- bf16 on the tensor cores ------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kLdX = kMaxP + 8;   // bf16 row stride of a staged x tile
constexpr int kHeadsTc = 4;       // heads per pass-3 block: C.B^T is shared by them
constexpr int kThreadsOut = 4 * 32 * kHeadsTc;  // pass 3: 4 row warps per head
constexpr int kLdCB = kTile + 8;  // fp32 row stride of the shared C.B^T tile
constexpr float kLog2e = 1.4426950408889634f;

// w * B for the 8 bf16 values of B in braw, split into bf16 hi + lo with
// hi + lo = w * B to ~2^-17 relative (v - hi is exact in fp32).
__device__ __forceinline__ void split_scaled(const uint4 braw, float w, uint4& hi, uint4& lo) {
  const uint32_t u[4] = {braw.x, braw.y, braw.z, braw.w};
  uint32_t hv[4], lv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v0 = __uint_as_float(u[i] << 16) * w;
    const float v1 = __uint_as_float(u[i] & 0xffff0000u) * w;
    hv[i] = tc::pack_bf16(v0, v1);
    lv[i] = tc::pack_bf16(v0 - __uint_as_float(hv[i] << 16),
                          v1 - __uint_as_float(hv[i] & 0xffff0000u));
  }
  hi = make_uint4(hv[0], hv[1], hv[2], hv[3]);
  lo = make_uint4(lv[0], lv[1], lv[2], lv[3]);
}

// Async copy of 64 rows of n bf16 (global row stride gs elements) into
// shared rows of stride ld, rows [rows_valid, 64) zero-filled.
__device__ __forceinline__ void cp_rows_bf16(bf16* __restrict__ dst, int ld,
                                             const bf16* __restrict__ src, size_t gs, int n,
                                             int rows_valid, int tid) {
  const int cpr = n / 8;  // 16-byte chunks per row
  for (int i = tid; i < kTile * cpr; i += blockDim.x) {
    const int r = i / cpr;
    const int c = (i % cpr) * 8;
    const bool ok = r < rows_valid;
    tc::cp_async16(dst + r * ld + c, ok ? src + (size_t)r * gs + c : src, ok ? 16 : 0);
  }
}

// Pass 1, bf16.  grid (chunks, H, Bt).  Shared memory: w [Q rounded to 4]
// (cum first), then bf16 (w B) hi and lo [64][N + 8] and a ring of two
// slots of x[64][kLdX] and B[64][N + 8]: the next tile loads while this one
// is computed.  The summary x^T (w B) is (P, N): warp w owns its
// rows 16 (w % 4) .. + 15 and the 16-column pairs w / 4, w / 4 + 2, ...; the
// depth is the chunk's positions, 64 at a time.
template <bool Grouped>
__global__ void __launch_bounds__(kThreads)
chunk_state_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ A, const bf16* __restrict__ Bm,
                      float* __restrict__ cum, float* __restrict__ states, int S, int H, int P,
                      int N, int G, int Q) {
  const int LDB = N + 8;
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);
  bf16* s_hi = reinterpret_cast<bf16*>(s_w + ((Q + 3) & ~3));
  bf16* s_lo = s_hi + kTile * LDB;
  bf16* s_ring = s_lo + kTile * LDB;  // each slot: x, then B
  const int slot_elems = kTile * (kLdX + LDB);
  __shared__ float s_warp[kWarps];
  __shared__ float s_carry;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int L = min(Q, S - s0);
  const float a = A[h];
  const int n_tiles = (L + kTile - 1) / kTile;

  const size_t ldbc = Grouped ? (size_t)G * N : (size_t)N;  // B row stride
  const bf16* xb = x + ((size_t)b * S + s0) * H * P + (size_t)h * P;
  const bf16* bb = Bm + ((size_t)b * S + s0) * ldbc + (Grouped ? (size_t)(h / (H / G)) * N : 0);
  const float* dtb = dt + ((size_t)b * S + s0) * H + h;
  float* out = states + (((size_t)b * H + h) * nc + c) * P * N;

  auto stage = [&](int t) {  // tile t into slot t % 2
    bf16* sx = s_ring + (t & 1) * slot_elems;
    const int rows = min(kTile, L - t * kTile);
    cp_rows_bf16(sx, kLdX, xb + (size_t)t * kTile * H * P, (size_t)H * P, P, rows, tid);
    cp_rows_bf16(sx + kTile * kLdX, LDB, bb + (size_t)t * kTile * ldbc, ldbc, N, rows, tid);
    tc::cp_async_commit();
  };
  stage(0);  // lands while w is formed

  chunk_cumsum(dtb, H, a, L, s_w, s_warp, &s_carry);
  float* cum_bh = cum + ((size_t)b * H + h) * S + s0;
  const float cum_last = s_w[L - 1];
  __syncthreads();  // every thread has read cum_last
  for (int t = tid; t < L; t += kThreads) {  // cum out, w in its place
    const float ct = s_w[t];
    cum_bh[t] = ct;
    s_w[t] = expf(cum_last - ct) * dtb[(size_t)t * H];
  }

  const int mt = warp & 3;
  const int par = warp >> 2;
  const bool rows_ok = mt * 16 < P;
  const int bvpr = N / 8;  // 16-byte vectors per row of B
  float acc[8][2][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][u][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * kTile;
    const bf16* sx = s_ring + (t & 1) * slot_elems;
    const bf16* sb = sx + kTile * kLdX;
    tc::cp_async_wait<0>();
    __syncthreads();  // tile t and w are visible; tile t - 1 is consumed
    if (t + 1 < n_tiles) stage(t + 1);  // into the slot tile t - 1 left
    for (int i = tid; i < kTile * bvpr; i += kThreads) {
      const int r = i / bvpr;
      const int cc = (i % bvpr) * 8;
      uint4 hi, lo;
      split_scaled(*reinterpret_cast<const uint4*>(sb + r * LDB + cc),
                   j0 + r < L ? s_w[j0 + r] : 0.f, hi, lo);
      *reinterpret_cast<uint4*>(s_hi + r * LDB + cc) = hi;
      *reinterpret_cast<uint4*>(s_lo + r * LDB + cc) = lo;
    }
    __syncthreads();
    if (rows_ok) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        uint32_t xa[4];  // A = x^T: rows p, depth j, by ldmatrix.trans of x[j][p]
        tc::ldmatrix_x4_trans(xa, sx + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * kLdX +
                                      mt * 16 + ((lane >> 3) & 1) * 8);
        const int brow = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + (lane >> 4) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int pair = 2 * i + par;
          if (pair * 16 < N) {
            uint32_t bh[4], bl[4];
            tc::ldmatrix_x4_trans(bh, s_hi + brow + pair * 16);
            tc::ldmatrix_x4_trans(bl, s_lo + brow + pair * 16);
            tc::mma_bf16(acc[i][0], xa, bh[0], bh[1]);
            tc::mma_bf16(acc[i][0], xa, bl[0], bl[1]);
            tc::mma_bf16(acc[i][1], xa, bh[2], bh[3]);
            tc::mma_bf16(acc[i][1], xa, bl[2], bl[3]);
          }
        }
      }
    }
  }
  if (!rows_ok) return;
  const int p = mt * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int pair = 2 * i + par;
    if (pair * 16 >= N) continue;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = pair * 16 + u * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(out + (size_t)p * N + n) = make_float2(acc[i][u][0], acc[i][u][1]);
      *reinterpret_cast<float2*>(out + (size_t)(p + 8) * N + n) =
          make_float2(acc[i][u][2], acc[i][u][3]);
    }
  }
}

// Stage column tile [j0, j0 + rj) of pass 3 into one ring slot by cp.async:
// B_j (rows ldbc apart), the block's heads' x_j, cum_j and dt_j (rows past
// the chunk, and heads from h_end on, zero).
__device__ __forceinline__ void stage_column_tile(bf16* s_b, bf16* s_x, float* s_cum_j,
                                                  float* s_dt_j, const bf16* bb, const bf16* xb,
                                                  const float* cum_b, const float* dtb, int j0,
                                                  int rj, int h0, int h_end, int S, int H, int P,
                                                  int N, size_t ldbc, int tid) {
  cp_rows_bf16(s_b, N + 8, bb + (size_t)j0 * ldbc, ldbc, N, rj, tid);
#pragma unroll
  for (int hh = 0; hh < kHeadsTc; ++hh) {
    const int h = h0 + hh;
    cp_rows_bf16(s_x + hh * kTile * kLdX, kLdX, xb + ((size_t)j0 * H + min(h, h_end - 1)) * P,
                 (size_t)H * P, P, h < h_end ? rj : 0, tid);
  }
  for (int i = tid; i < kHeadsTc * kTile; i += blockDim.x) {
    const int h = h0 + i / kTile;
    const int r = i % kTile;
    const bool ok = r < rj && h < h_end;
    tc::cp_async4(s_cum_j + i, ok ? cum_b + (size_t)h * S + j0 + r : cum_b, ok ? 4 : 0);
    tc::cp_async4(s_dt_j + i, ok ? dtb + (size_t)(j0 + r) * H + h : dtb, ok ? 4 : 0);
  }
}

// Pass 3, bf16.  grid (chunks, G * ceil((H / G) / kHeadsTc), row tiles * Bt),
// the heaviest row tiles first; kThreadsOut threads.  A block's heads lie in
// one group, whose C_i . B_j^T they share.  Warp w owns the tile's rows
// 16 (w % 4) .. + 15 and head w / 4 of the block's group.  Shared memory:
// cum_i[kHeadsTc][64], cum_j and dt_j [2][kHeadsTc][64], CB[64][kLdCB] fp32,
// then bf16 C_i[64][N + 8], B_j[2][64][N + 8] and x_j[2][kHeadsTc][64][kLdX]
// (after the column tiles, B_j and x_j hold the group's entering states).
template <bool Grouped>
__global__ void __launch_bounds__(kThreadsOut)
chunk_out_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                    const float* __restrict__ cum, const float* __restrict__ states,
                    int has_init, bf16* __restrict__ y, int Bt, int S, int H, int P, int N,
                    int G, int Q) {
  const int LDB = N + 8;
  extern __shared__ float4 smem4[];
  float* s_cum_i = reinterpret_cast<float*>(smem4);
  float* s_cum_j = s_cum_i + kHeadsTc * kTile;
  float* s_dt_j = s_cum_j + 2 * kHeadsTc * kTile;
  float* s_cb = s_dt_j + 2 * kHeadsTc * kTile;
  bf16* s_c = reinterpret_cast<bf16*>(s_cb + kTile * kLdCB);
  bf16* s_b = s_c + kTile * LDB;
  bf16* s_x = s_b + 2 * kTile * LDB;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t4 = lane & 3;
  const int c = blockIdx.x;
  const int Hg = Grouped ? H / G : H;                              // heads a group
  const int per_g = Grouped ? (Hg + kHeadsTc - 1) / kHeadsTc : 1;  // blocks a group
  const int g = Grouped ? blockIdx.y / per_g : 0;
  const int h0 = Grouped ? g * Hg + (blockIdx.y % per_g) * kHeadsTc : blockIdx.y * kHeadsTc;
  const int h_end = Grouped ? g * Hg + Hg : H;  // the group's last head + 1
  const size_t ldbc = Grouped ? (size_t)G * N : (size_t)N;  // B/C row stride
  const int n_it = (Q + kTile - 1) / kTile;
  const int it = n_it - 1 - blockIdx.z / Bt;
  const int b = blockIdx.z % Bt;
  const int nc = gridDim.x;
  const int s0 = c * Q;
  const int L = min(Q, S - s0);
  const int i0 = it * kTile;
  if (i0 >= L) return;
  const int ri = min(kTile, L - i0);
  const int rw = warp & 3;
  const int hh = warp >> 2;  // this warp's head in the group
  const int row_lo = rw * 16 + (lane >> 2);  // this thread's two rows of the tile
  const int row_hi = row_lo + 8;

  const bf16* xb = x + ((size_t)b * S + s0) * H * P;
  const bf16* bb = Bm + ((size_t)b * S + s0) * ldbc + (Grouped ? (size_t)g * N : 0);
  const bf16* cb = Cm + ((size_t)b * S + s0) * ldbc + (Grouped ? (size_t)g * N : 0);
  const float* dtb = dt + ((size_t)b * S + s0) * H;
  const float* cum_b = cum + (size_t)b * H * S + s0;

  cp_rows_bf16(s_c, LDB, cb + (size_t)i0 * ldbc, ldbc, N, ri, tid);
  for (int i = tid; i < kHeadsTc * kTile; i += kThreadsOut) {
    const int h = h0 + i / kTile;
    const int r = i % kTile;
    const bool ok = r < ri && h < h_end;
    tc::cp_async4(s_cum_i + i, ok ? cum_b + (size_t)h * S + i0 + r : cum_b, ok ? 4 : 0);
  }
  stage_column_tile(s_b, s_x, s_cum_j, s_dt_j, bb, xb, cum_b, dtb, 0, min(kTile, L), h0, h_end, S,
                    H, P, N, ldbc, tid);
  tc::cp_async_commit();

  float acc[8][4];  // [8 columns of P][fragment]
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int f = 0; f < 4; ++f) acc[n][f] = 0.f;

  for (int jt = 0; jt <= it; ++jt) {
    const int st = jt & 1;
    if (jt < it) {  // the next column tile loads while this one is computed
      const int nj = (jt + 1) * kTile;
      stage_column_tile(s_b + (st ^ 1) * kTile * LDB, s_x + (st ^ 1) * kHeadsTc * kTile * kLdX,
                        s_cum_j + (st ^ 1) * kHeadsTc * kTile,
                        s_dt_j + (st ^ 1) * kHeadsTc * kTile, bb, xb, cum_b, dtb, nj,
                        min(kTile, L - nj), h0, h_end, S, H, P, N, ldbc, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this column tile (and C_i) has landed
    __syncthreads();

    // CB = C_i . B_j^T, once for the group: this warp's 16 rows x 16 columns
    {
      const bf16* sb = s_b + st * kTile * LDB;
      float cbp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int f = 0; f < 4; ++f) cbp[n][f] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t ca[4], bf[4];
        tc::ldmatrix_x4(ca, s_c + (rw * 16 + (lane & 15)) * LDB + kk * 16 + (lane >> 4) * 8);
        tc::ldmatrix_x4(bf, sb + (hh * 16 + (lane & 7) + (lane >> 4) * 8) * LDB + kk * 16 +
                                ((lane >> 3) & 1) * 8);
        tc::mma_bf16(cbp[0], ca, bf[0], bf[1]);
        tc::mma_bf16(cbp[1], ca, bf[2], bf[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = hh * 16 + n * 8 + t4 * 2;
        *reinterpret_cast<float2*>(s_cb + row_lo * kLdCB + col) = make_float2(cbp[n][0], cbp[n][1]);
        *reinterpret_cast<float2*>(s_cb + row_hi * kLdCB + col) = make_float2(cbp[n][2], cbp[n][3]);
      }
    }
    __syncthreads();

    // att = CB * exp(cum_i - cum_j) * dt_j for this warp's head, masked to
    // j <= i (and to the valid rows and columns) before the exp, packed to
    // bf16 as the A fragment of acc += att . x_j.  Column col of this
    // thread's row is kept when col <= last_lo (last_hi).
    const int rj = min(kTile, L - jt * kTile);
    const int last_lo = row_lo < ri ? min(rj - 1, jt == it ? row_lo : kTile - 1) : -1;
    const int last_hi = row_hi < ri ? min(rj - 1, jt == it ? row_hi : kTile - 1) : -1;
    const float* cj = s_cum_j + (st * kHeadsTc + hh) * kTile;
    const float* dj = s_dt_j + (st * kHeadsTc + hh) * kTile;
    const bf16* xs = s_x + (st * kHeadsTc + hh) * kTile * kLdX;
    const float ci_lo = s_cum_i[hh * kTile + row_lo] * kLog2e;
    const float ci_hi = s_cum_i[hh * kTile + row_hi] * kLog2e;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      float att[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = (2 * kk + u) * 8 + t4 * 2;
        const float2 cbl = *reinterpret_cast<const float2*>(s_cb + row_lo * kLdCB + col);
        const float2 cbh = *reinterpret_cast<const float2*>(s_cb + row_hi * kLdCB + col);
        const float2 cjv = *reinterpret_cast<const float2*>(cj + col);
        const float2 djv = *reinterpret_cast<const float2*>(dj + col);
        // exp(cum_i - cum_j) = 2^(cum_i log2 e - cum_j log2 e); 2^-inf = 0
        att[u][0] = cbl.x * djv.x *
                    tc::exp2_approx(col <= last_lo ? fmaf(-cjv.x, kLog2e, ci_lo) : -INFINITY);
        att[u][1] = cbl.y * djv.y *
                    tc::exp2_approx(col + 1 <= last_lo ? fmaf(-cjv.y, kLog2e, ci_lo) : -INFINITY);
        att[u][2] = cbh.x * djv.x *
                    tc::exp2_approx(col <= last_hi ? fmaf(-cjv.x, kLog2e, ci_hi) : -INFINITY);
        att[u][3] = cbh.y * djv.y *
                    tc::exp2_approx(col + 1 <= last_hi ? fmaf(-cjv.y, kLog2e, ci_hi) : -INFINITY);
      }
      const uint32_t aa[4] = {tc::pack_bf16(att[0][0], att[0][1]), tc::pack_bf16(att[0][2], att[0][3]),
                              tc::pack_bf16(att[1][0], att[1][1]), tc::pack_bf16(att[1][2], att[1][3])};
#pragma unroll
      for (int pp = 0; pp < kMaxP / 16; ++pp) {
        if (pp * 16 < P) {
          uint32_t xf[4];
          tc::ldmatrix_x4_trans(xf, xs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdX +
                                        pp * 16 + (lane >> 4) * 8);
          tc::mma_bf16(acc[2 * pp], aa, xf[0], xf[1]);
          tc::mma_bf16(acc[2 * pp + 1], aa, xf[2], xf[3]);
        }
      }
    }
    __syncthreads();  // this ring slot and CB are rewritten next
  }

  // the entering state's term, exp(cum_i) (C_i . state_in^T): zero for the
  // first chunk without init_state.  The group's states are rounded to bf16
  // into the B_j and x_j space, head k at rows 64 k.
  if (has_init || c > 0) {
    const int PN4 = P * (N / 4);  // float4s per head
    for (int base = tid; base < kHeadsTc * PN4; base += 4 * kThreadsOut) {
      float4 v[4];  // four loads in flight per thread
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kThreadsOut;
        const int h = h0 + i / PN4;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < kHeadsTc * PN4 && h < h_end)
          v[u] = *reinterpret_cast<const float4*>(
              states + (((size_t)b * H + h) * nc + c) * P * N + (size_t)(i % PN4) * 4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = base + u * kThreadsOut;
        if (i >= kHeadsTc * PN4) break;
        const int p = (i % PN4) / (N / 4);
        const int n = (i % (N / 4)) * 4;
        *reinterpret_cast<uint2*>(s_b + ((i / PN4) * kTile + p) * LDB + n) =
            make_uint2(tc::pack_bf16(v[u].x, v[u].y), tc::pack_bf16(v[u].z, v[u].w));
      }
    }
    __syncthreads();
    const bf16* ss = s_b + hh * kTile * LDB;
    float inter[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int f = 0; f < 4; ++f) inter[n][f] = 0.f;
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t ca[4];
      tc::ldmatrix_x4(ca, s_c + (rw * 16 + (lane & 15)) * LDB + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int pp = 0; pp < kMaxP / 16; ++pp) {
        if (pp * 16 < P) {
          uint32_t sf[4];
          tc::ldmatrix_x4(sf, ss + (pp * 16 + (lane & 7) + (lane >> 4) * 8) * LDB + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
          tc::mma_bf16(inter[2 * pp], ca, sf[0], sf[1]);
          tc::mma_bf16(inter[2 * pp + 1], ca, sf[2], sf[3]);
        }
      }
    }
    const float e_lo = tc::exp2_approx(s_cum_i[hh * kTile + row_lo] * kLog2e);
    const float e_hi = tc::exp2_approx(s_cum_i[hh * kTile + row_hi] * kLog2e);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] += inter[n][0] * e_lo;
      acc[n][1] += inter[n][1] * e_lo;
      acc[n][2] += inter[n][2] * e_hi;
      acc[n][3] += inter[n][3] * e_hi;
    }
  }

  const int h = h0 + hh;
  if (h >= h_end) return;
  bf16* yb = y + (((size_t)b * S + s0 + i0) * H + h) * P;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    if (n * 8 >= P) continue;
    const int p = n * 8 + t4 * 2;
    if (row_lo < ri)
      *reinterpret_cast<uint32_t*>(yb + (size_t)row_lo * H * P + p) =
          tc::pack_bf16(acc[n][0], acc[n][1]);
    if (row_hi < ri)
      *reinterpret_cast<uint32_t*>(yb + (size_t)row_hi * H * P + p) =
          tc::pack_bf16(acc[n][2], acc[n][3]);
  }
}

template <bool Grouped>
cudaError_t launch_bf16(const void* x, const float* dt, const float* A, const void* Bm,
                        const void* Cm, const float* init_state, void* y, float* final_state,
                        float* cum, float* states, int Bt, int S, int H, int P, int N, int G,
                        int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int n_it = (Q + kTile - 1) / kTile;
  const int LDB = N + 8;

  const size_t smem1 = sizeof(float) * (size_t)((Q + 3) & ~3) +
                       sizeof(bf16) * (size_t)(2 * kTile * LDB + 2 * kTile * (kLdX + LDB));
  cudaError_t err = cudaFuncSetAttribute(chunk_state_tc_kernel<Grouped>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  chunk_state_tc_kernel<Grouped><<<dim3(nc, H, Bt), kThreads, smem1, stream>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm), cum, states, S, H, P, N,
      G, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  state_scan_kernel<<<dim3((P * N + kThreads - 1) / kThreads, H, Bt), kThreads, 0, stream>>>(
      states, cum, init_state, final_state, S, H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem3 = sizeof(float) * (size_t)(5 * kHeadsTc * kTile + kTile * kLdCB) +
                       sizeof(bf16) * (size_t)(3 * kTile * LDB + 2 * kHeadsTc * kTile * kLdX);
  err = cudaFuncSetAttribute(chunk_out_tc_kernel<Grouped>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  const int per_g = (H / G + kHeadsTc - 1) / kHeadsTc;
  chunk_out_tc_kernel<Grouped><<<dim3(nc, G * per_g, n_it * Bt), kThreadsOut, smem3, stream>>>(
      static_cast<const bf16*>(x), dt, static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      cum, states, init_state != nullptr, static_cast<bf16*>(y), Bt, S, H, P, N, G, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y).  x (Bt, S, H, P),
// dt (Bt, S, H) fp32, A (H,) fp32, B/C (Bt, S, G, N) with G dividing H,
// init_state (Bt, H, P, N)
// fp32 or null (zeros), y (Bt, S, H, P), final_state (Bt, H, P, N) fp32;
// scratch: cum (Bt, H, S) fp32 and states (Bt, H, ceil(S/Q), P, N) fp32.
// Q is the chunk length (the caller's min(chunk, S)).  1 <= P <= 64,
// 1 <= N <= 256, 1 <= Q <= 4096; bf16 (the tensor-core passes) also needs P
// and N multiples of 16 and x, B, C 16-byte aligned.  All contiguous on
// `device`.  Launches three kernels on `stream` without synchronising;
// returns the first failing launch's cudaError_t (cudaErrorInvalidValue for
// unsupported arguments).
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* init_state, void* y,
                             void* final_state, void* cum, void* states, int Bt, int S, int H,
                             int P, int N, int G, int Q, int dtype, int device, void* stream) {
  if (Bt < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || Q > S || G < 1 || H % G)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* init = static_cast<const float*>(init_state);
  float* fs = static_cast<float*>(final_state);
  float* cumf = static_cast<float*>(cum);
  float* sts = static_cast<float*>(states);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(G > 1 ? launch<float, true> : launch<float, false>)(
        x, dtf, Af, Bm, Cm, init, y, fs, cumf, sts, Bt, S, H, P, N, G, Q, st);
  if (dtype == 1 && P % 16 == 0 && N % 16 == 0)
    return (int)(G > 1 ? launch_bf16<true> : launch_bf16<false>)(
        x, dtf, Af, Bm, Cm, init, y, fs, cumf, sts, Bt, S, H, P, N, G, Q, st);
  return (int)cudaErrorInvalidValue;
}
