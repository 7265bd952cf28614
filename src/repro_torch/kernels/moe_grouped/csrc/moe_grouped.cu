// Dropless grouped relu^2 expert FFN for Hopper (sm_90a): bf16 on the
// tensor cores (mma.sync), fp32 on scalar FP32 FMA.
//
// Replaces no TPU kernel: the reference's MoE runs its experts as a batched
// product over a capacity buffer (E, C, D), which computes C rows for every
// expert whatever was routed to it and drops what overflows.  These kernels
// run each expert over its own rows only.  The caller sorts the n*k
// assignments by expert and hands the experts' row offsets over on the
// device, so the grid is fixed by the shapes alone, (experts, column tiles),
// and the decode step stays capturable as one CUDA graph:
//
//   moe_grouped_up_kernel:   h[r]       = relu(x[rows[r]] @ wu[e]) ** 2
//                            (the token rows gathered as they load; h in
//                            x's type)
//   moe_grouped_down_kernel: out[dest[r]] = scale[r] * (h[r] @ wd[e])
//                            (fp32, in the assignments' order, for the
//                            caller's sum over each token's experts)
//
// for r in [offsets[e], offsets[e + 1]).  A block owns one (expert, 64
// output columns) and loops over its expert's rows BM at a time (16, 32 or
// 64: the wrapper picks it from the mean rows an expert gets) and over the
// depth in steps of 64; an expert with no row exits at once.
//
// Bound on an H100 SXM (989e12 bf16 FLOP/s dense, 3.35e12 B/s HBM3): at
// decode (64 tokens, top-6 of 128 experts of 2688 x 1856) every expert that
// is hit is read whole, 2 x 2688 x 1856 x 2 B = 20 MB an expert; the FLOPs,
// 4 n k D F, are a few percent of that time.  A prefill of S tokens reads
// every expert too, and bytes bound it below about 300 rows an expert.  So
// the design streams the weights: each block reads its 64 columns of its
// expert's matrix once per BM rows.
//
// bf16 (the tensor-core path):
//   - the weight tile (64 deep x 64 columns) and the rows' tile (BM x 64)
//     go bf16 into shared memory by 16-byte cp.async.cg copies in a
//     four-stage ring, so three tiles load while one is computed; rows are
//     padded by 16 bytes so that ldmatrix's row addresses fall in distinct
//     bank groups; rows past the expert's last, and depth or columns past
//     the matrix, are zero-filled by the copy itself;
//   - each of the four warps owns 16 of the 64 columns for all BM rows:
//     the rows come by ldmatrix, the weights (depth x columns, columns
//     contiguous) by ldmatrix.trans, into mma.sync m16n8k16 with fp32
//     accumulators; row tiles past the expert's rows are skipped;
//   - up squares relu of the accumulator and stores it rounded to bf16;
//     down scales it by the assignment's weight and stores fp32.
// 46 KB of shared memory at BM 16, 74 KB at BM 64.
//
// fp32 keeps scalar IEEE FMA (held to 1e-5 of the plain version, which
// TF32 products cannot meet): a block of 64 x 4 threads, a thread per
// column and four of each 16 rows, the rows' tile staged in shared memory.
//
// Left for later: wgmma from shared memory, a TMA ring with mbarriers, and
// a persistent schedule over (expert, column tile).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBN = 64;        // output columns a block
constexpr int kBK = 64;        // depth a stage
constexpr int kLD = kBK + 8;   // padded row of a shared tile (kBK == kBN)
constexpr int kStages = 4;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int BM>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)kStages * (BM + kBK) * kLD;
}

// One stage: the rows' tile (BM rows of depth [k0, k0 + 64), row i reading
// a_row[i], or zeros where a_row[i] < 0) and the weight tile (depth
// [k0, k0 + 64) x columns [n0, n0 + 64) of a K x N row-major matrix).
template <int BM>
__device__ __forceinline__ void load_stage(__nv_bfloat16* __restrict__ sa,
                                           __nv_bfloat16* __restrict__ sb,
                                           const __nv_bfloat16* __restrict__ a,
                                           const long long* __restrict__ a_row,
                                           const __nv_bfloat16* __restrict__ w, int K,
                                           int N, int k0, int n0, int tid) {
  constexpr int CPR = kBK / 8;  // 16-byte chunks a row of a tile
#pragma unroll
  for (int it = 0; it < BM * CPR / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const long long row = a_row[r];
    const bool ok = row >= 0 && k0 + c < K;
    tc::cp_async16(sa + r * kLD + c, ok ? a + row * K + k0 + c : a, ok ? 16 : 0);
  }
#pragma unroll
  for (int it = 0; it < kBK * CPR / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool ok = k0 + r < K && n0 + c < N;
    tc::cp_async16(sb + r * kLD + c, ok ? w + (size_t)(k0 + r) * N + n0 + c : w, ok ? 16 : 0);
  }
}

// The block's (expert, 64 columns) over its expert's rows: Up gathers
// x[rows[r]] (K = D, N = F) and stores relu^2 as bf16 into h; down reads
// h[r] (K = F, N = D) and stores scale[r] times it as fp32 into out[dest[r]].
template <bool Up, int BM>
__device__ __forceinline__ void grouped_bf16(const __nv_bfloat16* __restrict__ a,
                                             const long long* __restrict__ rows,
                                             const long long* __restrict__ dest,
                                             const float* __restrict__ scale,
                                             const int* __restrict__ offsets,
                                             const __nv_bfloat16* __restrict__ w,
                                             __nv_bfloat16* __restrict__ h,
                                             float* __restrict__ out, int K, int N) {
  constexpr int MT = BM / 16;  // row tiles of 16
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kStages][BM][kLD]
  __nv_bfloat16* sb = sa + kStages * BM * kLD;                  // [kStages][kBK][kLD]
  __shared__ long long a_row[BM];

  const int e = blockIdx.x;
  const int n0 = blockIdx.y * kBN;
  const int lo = offsets[e];
  const int hi = offsets[e + 1];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const __nv_bfloat16* we = w + (size_t)e * K * N;
  const int nk = (K + kBK - 1) / kBK;

  for (int m0 = lo; m0 < hi; m0 += BM) {
    const int live = min(BM, hi - m0);
    for (int i = tid; i < BM; i += kThreads)
      a_row[i] = i < live ? (Up ? rows[m0 + i] : (long long)(m0 + i)) : -1;
    __syncthreads();
    float acc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk)
        load_stage<BM>(sa + s * BM * kLD, sb + s * kBK * kLD, a, a_row, we, K, N, s * kBK, n0,
                       tid);
      tc::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      tc::cp_async_wait<kStages - 2>();  // stage kt has landed
      __syncthreads();                   // and the stage refilled below is free
      const int nx = kt + kStages - 1;
      if (nx < nk)
        load_stage<BM>(sa + (nx % kStages) * BM * kLD, sb + (nx % kStages) * kBK * kLD, a,
                       a_row, we, K, N, nx * kBK, n0, tid);
      tc::cp_async_commit();
      const __nv_bfloat16* as = sa + (kt % kStages) * BM * kLD;
      const __nv_bfloat16* bs = sb + (kt % kStages) * kBK * kLD;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t bf[4];
        tc::ldmatrix_x4_trans(bf, bs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLD +
                                      warp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt * 16 < live) {  // warp-uniform: row tiles past the rows are skipped
            uint32_t af[4];
            tc::ldmatrix_x4(af, as + (mt * 16 + (lane & 15)) * kLD + kk * 16 + (lane >> 4) * 8);
            tc::mma_bf16(acc[mt][0], af, bf[0], bf[1]);
            tc::mma_bf16(acc[mt][1], af, bf[2], bf[3]);
          }
        }
      }
    }
    tc::cp_async_wait<0>();

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + g + half * 8;
        if (r >= live) continue;
        float sc = 1.f;
        size_t base;
        if constexpr (Up) {
          base = (size_t)(m0 + r) * N;
        } else {
          sc = scale[m0 + r];
          base = (size_t)dest[m0 + r] * N;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + warp * 16 + j * 8 + t4 * 2;
          if (col >= N) continue;
          float v0 = acc[mt][j][half * 2], v1 = acc[mt][j][half * 2 + 1];
          if constexpr (Up) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
            *reinterpret_cast<uint32_t*>(h + base + col) = tc::pack_bf16(v0 * v0, v1 * v1);
          } else {
            *reinterpret_cast<float2*>(out + base + col) = make_float2(v0 * sc, v1 * sc);
          }
        }
      }
    }
    __syncthreads();  // a_row and the ring are refilled for the next rows
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
moe_grouped_up_kernel(const __nv_bfloat16* __restrict__ x, const long long* __restrict__ rows,
                      const int* __restrict__ offsets, const __nv_bfloat16* __restrict__ wu,
                      __nv_bfloat16* __restrict__ h, int D, int F) {
  grouped_bf16<true, BM>(x, rows, nullptr, nullptr, offsets, wu, h, nullptr, D, F);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
moe_grouped_down_kernel(const __nv_bfloat16* __restrict__ h, const long long* __restrict__ dest,
                        const float* __restrict__ scale, const int* __restrict__ offsets,
                        const __nv_bfloat16* __restrict__ wd, float* __restrict__ out, int F,
                        int D) {
  grouped_bf16<false, BM>(h, nullptr, dest, scale, offsets, wd, nullptr, out, F, D);
}

// ---- fp32: scalar FMA ---------------------------------------------------------

constexpr int kRowsF = 16;  // rows a pass
constexpr int kDepthF = 32;  // depth staged a step

template <bool Up>
__device__ __forceinline__ void grouped_f32(const float* __restrict__ a,
                                            const long long* __restrict__ rows,
                                            const long long* __restrict__ dest,
                                            const float* __restrict__ scale,
                                            const int* __restrict__ offsets,
                                            const float* __restrict__ w, float* __restrict__ h,
                                            float* __restrict__ out, int K, int N) {
  __shared__ float sa[kRowsF][kDepthF + 1];
  __shared__ long long a_row[kRowsF];
  const int e = blockIdx.x;
  const int col = blockIdx.y * kBN + threadIdx.x;
  const int ty = threadIdx.y;  // rows ty, ty + 4, ty + 8, ty + 12 of a pass
  const int tid = ty * kBN + threadIdx.x;
  const int lo = offsets[e];
  const int hi = offsets[e + 1];
  const float* we = w + (size_t)e * K * N;
  for (int m0 = lo; m0 < hi; m0 += kRowsF) {
    const int live = min(kRowsF, hi - m0);
    if (tid < kRowsF)
      a_row[tid] = tid < live ? (Up ? rows[m0 + tid] : (long long)(m0 + tid)) : -1;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < K; k0 += kDepthF) {
      __syncthreads();
      for (int i = tid; i < kRowsF * kDepthF; i += kBN * 4) {
        const int r = i / kDepthF, c = i % kDepthF;
        const long long row = a_row[r];
        sa[r][c] = row >= 0 && k0 + c < K ? a[row * K + k0 + c] : 0.f;
      }
      __syncthreads();
      if (col < N) {
        const int kn = min(kDepthF, K - k0);
        for (int c = 0; c < kn; ++c) {
          const float b = we[(size_t)(k0 + c) * N + col];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = fmaf(sa[ty + 4 * j][c], b, acc[j]);
        }
      }
    }
    if (col < N) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 4 * j;
        if (r >= live) continue;
        if constexpr (Up) {
          const float v = fmaxf(acc[j], 0.f);
          h[(size_t)(m0 + r) * N + col] = v * v;
        } else {
          out[(size_t)dest[m0 + r] * N + col] = acc[j] * scale[m0 + r];
        }
      }
    }
    __syncthreads();
  }
}

__global__ void moe_grouped_up_f32_kernel(const float* __restrict__ x,
                                          const long long* __restrict__ rows,
                                          const int* __restrict__ offsets,
                                          const float* __restrict__ wu, float* __restrict__ h,
                                          int D, int F) {
  grouped_f32<true>(x, rows, nullptr, nullptr, offsets, wu, h, nullptr, D, F);
}

__global__ void moe_grouped_down_f32_kernel(const float* __restrict__ h,
                                            const long long* __restrict__ dest,
                                            const float* __restrict__ scale,
                                            const int* __restrict__ offsets,
                                            const float* __restrict__ wd, float* __restrict__ out,
                                            int F, int D) {
  grouped_f32<false>(h, nullptr, dest, scale, offsets, wd, nullptr, out, F, D);
}

template <int BM>
cudaError_t launch_bf16(const void* x, const long long* rows, const long long* dest,
                        const float* scale, const int* offsets, const void* wu, const void* wd,
                        void* h, float* out, int E, int D, int F, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BM>();
  // set once a device, at the first (eager) call: a graph captured later
  // makes no call but the launches
  static bool set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !set[dev]) {
    err = cudaFuncSetAttribute(moe_grouped_up_kernel<BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(moe_grouped_down_kernel<BM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) set[dev] = true;
  }
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* hb = static_cast<__nv_bfloat16*>(h);
  moe_grouped_up_kernel<BM><<<dim3(E, (F + kBN - 1) / kBN), kThreads, smem, stream>>>(
      xb, rows, offsets, static_cast<const __nv_bfloat16*>(wu), hb, D, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_grouped_down_kernel<BM><<<dim3(E, (D + kBN - 1) / kBN), kThreads, smem, stream>>>(
      hb, dest, scale, offsets, static_cast<const __nv_bfloat16*>(wd), out, F, D);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const long long* rows, const long long* dest,
                       const float* scale, const int* offsets, const void* wu, const void* wd,
                       void* h, float* out, int E, int D, int F, cudaStream_t stream) {
  const dim3 block(kBN, 4);
  moe_grouped_up_f32_kernel<<<dim3(E, (F + kBN - 1) / kBN), block, 0, stream>>>(
      static_cast<const float*>(x), rows, offsets, static_cast<const float*>(wu),
      static_cast<float*>(h), D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_grouped_down_f32_kernel<<<dim3(E, (D + kBN - 1) / kBN), block, 0, stream>>>(
      static_cast<const float*>(h), dest, scale, offsets, static_cast<const float*>(wd), out, F,
      D);
  return cudaGetLastError();
}

}  // namespace

// x (n, D); rows, dest (nk,) int64; scale (nk,) fp32; offsets (E + 1,)
// int32; wu (E, D, F), wd (E, F, D) in x's dtype; h (nk, F) in x's dtype
// and out (nk, D) fp32, written.  dtype: 0 = float32 (scalar FMA), 1 =
// bfloat16 (tensor cores; D and F multiples of 8, bm 16, 32 or 64).  All
// tensors contiguous on `device`, bf16 ones 16-byte aligned.  Launches both
// kernels on `stream` without synchronising; returns the first launch's
// cudaError_t (cudaErrorInvalidValue for an unsupported dtype or bm).
extern "C" int repro_moe_grouped(const void* x, const void* rows, const void* dest,
                                 const void* scale, const void* offsets, const void* wu,
                                 const void* wd, void* h, void* out, int E, int D, int F,
                                 int bm, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* r = static_cast<const long long*>(rows);
  const auto* d = static_cast<const long long*>(dest);
  const auto* s = static_cast<const float*>(scale);
  const auto* o = static_cast<const int*>(offsets);
  auto* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(x, r, d, s, o, wu, wd, h, y, E, D, F, st);
  if (dtype == 1 && bm == 16) return (int)launch_bf16<16>(x, r, d, s, o, wu, wd, h, y, E, D, F, st);
  if (dtype == 1 && bm == 32) return (int)launch_bf16<32>(x, r, d, s, o, wu, wd, h, y, E, D, F, st);
  if (dtype == 1 && bm == 64) return (int)launch_bf16<64>(x, r, d, s, o, wu, wd, h, y, E, D, F, st);
  return (int)cudaErrorInvalidValue;
}
