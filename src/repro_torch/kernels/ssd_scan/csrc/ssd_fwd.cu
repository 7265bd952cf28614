// Mamba2 chunked SSD scan forward for Hopper (sm_90a), scalar FP32 FMA.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (launched by ssd_scan_fwd through pl.pallas_call).  Same function, in the
// model layout: x (Bt, S, H, P) and B/C (Bt, S, N) in the compute type
// (fp32 or bf16), dt (Bt, S, H) and A (H,) in fp32, optional init_state
// (Bt, H, P, N) fp32.  The sequence is cut into chunks of Q positions (the
// last one may be shorter: the TPU kernel pads it with dt = 0, which adds
// nothing, so here it is simply masked).  Per (b, h) and chunk, with
// cum = cumsum(dt * A) inside the chunk:
//   y_i     = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) (C_i . state_in)
//   state  <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T
// y is written in x's type, the final state (Bt, H, P, N) in fp32.
//
// Structure.  The TPU kernel runs the grid (Bt, H, chunks) in order and
// carries the (P, N) state in VMEM scratch from chunk to chunk.  Hopper runs
// blocks in no order, so the carried state becomes a pass of its own and
// the heavy work runs in parallel over chunks:
//   1. chunk_state_kernel, one block per (chunk, h, b): the chunk's cum
//      (a block-wide scan; written out for passes 2 and 3) and its state
//      summary sum_j w_j x_j B_j^T, w_j = exp(cum_last - cum_j) dt_j, into
//      a (Bt, H, chunks, P, N) fp32 scratch;
//   2. state_scan_kernel, one thread per (b, h, p, n): walks the chunks in
//      order, replaces each summary with the state entering that chunk,
//      and writes the final state;
//   3. chunk_out_kernel, one block per (chunk, h, b, 64-row tile of the
//      chunk): the masked decay "attention" over the tile's columns up to
//      the diagonal plus the entering state's term, written once as y.
// Nothing of size Q x Q is ever held: the 64 x 64 block of
// (C_i . B_j) exp(cum_i - cum_j) dt_j is built from cum for one (row tile,
// column tile <= row tile) at a time, the mask applied before exp, and
// tiles above the diagonal are skipped.  Tiles are staged through shared
// memory as fp32; each of the 256 threads owns a 4 x 4 block
// of outputs, rows ty + 16k and columns tx + 16l, and reads float4s along
// the reduction axis (rows padded so that 8 neighbouring rows fall in
// distinct banks).  At the mamba2-370m serving shape (Bt=1, S=1024, Q=256,
// H=32, P=64, N=128) passes 1 and 3 launch 128 and 512 blocks.
//
// Arithmetic is IEEE fp32 (no TF32, no fast-math exp) for both input
// types, so the fp32 path agrees with the plain PyTorch version to rounding.
//
// Bound on an H100 SXM (datasheet: 989e12 bf16 FLOP/s dense on the tensor
// cores, 3.35e12 B/s HBM3): max(flops / 989e12, bytes / 3.35e12).  The
// least work at the serving shape is ~1.65 GFLOP (C.B^T once per chunk and
// shared by the heads, the causal half of it, then per head the
// attention-times-x, the state term and the summary), ~1.7 us; the bytes
// are |x| + |y| + |B| + |C| + |dt| + |final state| ~ 10.1 MB, ~3.0 us: the
// bytes bound.
//
// What this simple design leaves on the table: it runs on the FP32 CUDA
// cores (67e12 FLOP/s datasheet) instead of the tensor cores; it recomputes
// C.B^T for every head (B and C are shared by the heads), as the TPU kernel
// does; it stages tiles with plain scalar loads and no pipelining; the
// summaries go through a device-memory scratch between the passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;          // positions per tile
constexpr int kLdT = kTile + 4;    // row stride of a tile kept with positions contiguous
constexpr int kMaxP = 64;
constexpr int kPL = kMaxP / 16;  // output columns per thread: tx + 16l, l < kPL
constexpr int kMaxN = 256;
constexpr int kMaxQ = 4096;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   float* __restrict__ cum, float* __restrict__ states, int S,
                   int H, int P, int N, int Q) {
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

  const T* xb = x + ((size_t)b * S + s0) * H * P + (size_t)h * P;
  const T* bb = Bm + ((size_t)b * S + s0) * N;
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
            (jj < rj && n < N) ? to_f(bb[(size_t)(j0 + jj) * N + n]) * s_w[jj] : 0.f;
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ cum, const float* __restrict__ states,
                 T* __restrict__ y, int Bt, int S, int H, int P, int N, int Q) {
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

  const T* xb = x + ((size_t)b * S + s0) * H * P + (size_t)h * P;
  const T* bb = Bm + ((size_t)b * S + s0) * N;
  const T* cb = Cm + ((size_t)b * S + s0) * N;
  const float* dtb = dt + ((size_t)b * S + s0) * H + h;
  const float* cum_bh = cum + ((size_t)b * H + h) * S + s0;

  for (int i = tid; i < kTile * Npad; i += kThreads) {
    const int r = i / Npad;
    const int n = i % Npad;
    s_c[r * LDC + n] = (r < ri && n < N) ? to_f(cb[(size_t)(i0 + r) * N + n]) : 0.f;
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
      s_b[r * LDC + n] = (r < rj && n < N) ? to_f(bb[(size_t)(j0 + r) * N + n]) : 0.f;
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

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* init_state, void* y, float* final_state,
                   float* cum, float* states, int Bt, int S, int H, int P, int N, int Q,
                   cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q;
  const int n_it = (Q + kTile - 1) / kTile;
  const int LDC = row_stride(N);

  const size_t smem1 = sizeof(float) * (size_t)(((Q + 3) & ~3) + kTile + kMaxP * kLdT + kTile * kLdT);
  cudaError_t err = cudaFuncSetAttribute(chunk_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<T><<<dim3(nc, H, Bt), kThreads, smem1, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), cum, states, S, H, P, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  state_scan_kernel<<<dim3((P * N + kThreads - 1) / kThreads, H, Bt), kThreads, 0, stream>>>(
      states, cum, init_state, final_state, S, H, P, N, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem3 =
      sizeof(float) * (size_t)(2 * kTile * LDC + kMaxP * kLdT + kTile * kLdT + 3 * kTile);
  err = cudaFuncSetAttribute(chunk_out_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;
  chunk_out_kernel<T><<<dim3(nc, H, n_it * Bt), kThreads, smem3, stream>>>(
      static_cast<const T*>(x), dt, static_cast<const T*>(Bm), static_cast<const T*>(Cm), cum,
      states, static_cast<T*>(y), Bt, S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of x, B, C and y).  x (Bt, S, H, P),
// dt (Bt, S, H) fp32, A (H,) fp32, B/C (Bt, S, N), init_state (Bt, H, P, N)
// fp32 or null (zeros), y (Bt, S, H, P), final_state (Bt, H, P, N) fp32;
// scratch: cum (Bt, H, S) fp32 and states (Bt, H, ceil(S/Q), P, N) fp32.
// Q is the chunk length (the caller's min(chunk, S)).  1 <= P <= 64,
// 1 <= N <= 256, 1 <= Q <= 4096.  All contiguous on `device`.  Launches
// three kernels on `stream` without synchronising; returns the first
// failing launch's cudaError_t (cudaErrorInvalidValue for unsupported
// arguments).
extern "C" int repro_ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                             const void* Cm, const void* init_state, void* y,
                             void* final_state, void* cum, void* states, int Bt, int S, int H,
                             int P, int N, int Q, int dtype, int device, void* stream) {
  if (Bt < 1 || S < 1 || H < 1 || P < 1 || P > kMaxP || N < 1 || N > kMaxN || Q < 1 ||
      Q > kMaxQ || Q > S)
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
    return (int)launch<float>(x, dtf, Af, Bm, Cm, init, y, fs, cumf, sts, Bt, S, H, P, N, Q,
                                  st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, init, y, fs, cumf, sts, Bt, S, H,
                                          P, N, Q, st);
  return (int)cudaErrorInvalidValue;
}
