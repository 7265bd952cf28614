// Causal GQA flash-attention forward for Hopper (sm_90a), scalar FP32 FMA.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel
// (launched by flash_attention_fwd through pl.pallas_call).  Same function:
// q (B, H, Sq, hd), k/v (B, K, Skv, hd) with H = G*K; query head h reads KV
// head h / G; query row i sits at absolute position q_offset[b] + i; key j is
// visible when j < Skv and j <= q_offset[b] + i (causal); online softmax
// with fp32 m, l and acc; output in the input dtype.  The port only calls it
// causal, so the TPU kernel's non-causal switch is not carried over.
//
// Structure.  The TPU kernel carries acc/m/l in VMEM scratch across a
// sequential KV grid axis.  Hopper runs blocks in no order, so here one
// thread block owns one (b, h, 64-row query tile) and loops over 64-key KV
// tiles itself, stopping at the causal diagonal of its last valid row
// (q_offset[b] + last row), which is the TPU kernel's skip of blocks above
// the diagonal.  Each tile of K and V is staged through shared memory as
// fp32.  Four warps each own 16 query rows: for S = Q K^T lane j holds keys
// j and j + 32 of the tile; the row max is a warp shuffle; the probabilities
// go through a per-warp shared buffer so that for O += P V lane d holds
// output columns d, d + 32, ... of its 16 rows.  The row sum stays
// per-lane and is reduced once at the end.  Heavier (later) causal tiles
// are launched first.
//
// Arithmetic is IEEE fp32 FMA for both input types (no TF32, no fast-math
// exp), so the fp32 path agrees with the plain PyTorch version to rounding.
//
// Bound on an H100 SXM (datasheet: 989e12 bf16 FLOP/s dense on the tensor
// cores, 3.35e12 B/s HBM3): max(flops / 989e12, bytes / 3.35e12) with
// flops = 2 * 2 * B * H * Sq * Skv * hd, about halved by the causal mask, and
// bytes = |q| + |k| + |v| + |o|.  At the serving shape (B=1, H=K=36, hd=64,
// S=1024, bf16) that is about 4.8 GFLOP and 18.9 MB, so the bytes bound
// (~5.6 us) is the larger one.
//
// What this simple design leaves on the table: it runs on the FP32 CUDA
// cores (67e12 FLOP/s datasheet) instead of the tensor cores (wgmma or
// mma.sync in bf16); it stages K/V with plain loads and one buffer instead
// of a TMA ring with mbarriers, so load latency is not overlapped with math;
// it keeps tiles in fp32 in shared memory (66 KB at hd=64, 116 KB at
// hd=128), which caps residency at a few blocks per SM.  A tensor-core,
// warp-specialised version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16
constexpr int kKeysPerLane = kBlockK / 32;      // 2
constexpr float kNegInf = -1e30f;               // the reference's mask value

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Widen one 16-byte vector of T to fp32.  bf16 is the top half of an fp32
// word, so widening is a shift (little endian: the lower-addressed element
// is the low half).
template <typename T>
struct Unpack;
template <>
struct Unpack<float> {
  static constexpr int V = 4;
  __device__ __forceinline__ static void run(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};
template <>
struct Unpack<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ __forceinline__ static void run(const uint4& w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

// Stage 64 rows of HD elements (row stride HD in global memory) into shared
// memory as fp32 with row stride LD; rows at or past rows_valid are zeros.
// Each thread moves 16-byte vectors, neighbouring threads neighbouring
// addresses.
template <typename T, int HD, int LD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int rows_valid, int tid) {
  constexpr int V = Unpack<T>::V;  // elements per 16-byte vector
  constexpr int VPR = HD / V;      // vectors per row
  for (int i = tid; i < 64 * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * V;
    float f[V];
    if (r < rows_valid) {
      Unpack<T>::run(*reinterpret_cast<const uint4*>(src + (size_t)r * HD + c), f);
    } else {
#pragma unroll
      for (int t = 0; t < V; ++t) f[t] = 0.f;
    }
    float* d = dst + r * LD + c;
#pragma unroll
    for (int t = 0; t < V; t += 4)
      *reinterpret_cast<float4*>(d + t) = make_float4(f[t], f[t + 1], f[t + 2], f[t + 3]);
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(kBlockQ * HD + kBlockK * (HD + 4) + kBlockK * HD + kBlockQ * kBlockK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ q_offset, int H, int G, int Sq,
                 int Skv, float sm_scale) {
  constexpr int LDQ = HD;      // read as broadcast float4 rows
  constexpr int LDK = HD + 4;  // lane j reads row j: the pad spreads rows over banks
  constexpr int LDV = HD;      // lanes read neighbouring columns of one row
  constexpr int DPL = HD / 32; // output columns per lane

  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + kBlockQ * LDQ;
  float* sv = sk + kBlockK * LDK;
  float* sp = sv + kBlockK * LDV;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qtile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int K = H / G;
  const int kh = h / G;
  const int q0 = qtile * kBlockQ;
  const int q_rows = min(kBlockQ, Sq - q0);
  const int off = q_offset[b];

  const T* qb = q + (((size_t)b * H + h) * Sq + q0) * HD;
  const T* kb = k + ((size_t)b * K + kh) * Skv * HD;
  const T* vb = v + ((size_t)b * K + kh) * Skv * HD;
  // keys past the diagonal of the tile's last valid row are masked for
  // every row: stop there
  const int kv_end = min(Skv, off + q0 + q_rows);

  load_tile<T, HD, LDQ>(sq, qb, q_rows, tid);

  const int row0 = warp * kRowsPerWarp;
  float* wp = sp + row0 * kBlockK;  // this warp's probabilities

  float acc[kRowsPerWarp][DPL];
  float m[kRowsPerWarp];
  float l[kRowsPerWarp];  // this lane's share of the row sum
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and sq is staged)
    const int k_rows = min(kBlockK, Skv - k0);
    load_tile<T, HD, LDK>(sk, kb + (size_t)k0 * HD, k_rows, tid);
    load_tile<T, HD, LDV>(sv, vb + (size_t)k0 * HD, k_rows, tid);
    __syncthreads();

    // S = Q K^T for this warp's rows and this lane's keys
    float s[kRowsPerWarp][kKeysPerLane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) s[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kk[kKeysPerLane];
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j)
        kk[j] = *reinterpret_cast<const float4*>(sk + (lane + 32 * j) * LDK + d);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = *reinterpret_cast<const float4*>(sq + (row0 + r) * LDQ + d);
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          float t = s[r][j];
          t = fmaf(qq.x, kk[j].x, t);
          t = fmaf(qq.y, kk[j].y, t);
          t = fmaf(qq.z, kk[j].z, t);
          t = fmaf(qq.w, kk[j].w, t);
          s[r][j] = t;
        }
      }
    }

    // mask, online softmax; probabilities to the warp's shared buffer
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qpos = off + q0 + row0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int kpos = k0 + lane + 32 * j;
        const bool ok = kpos < Skv && kpos <= qpos;
        s[r][j] = ok ? s[r][j] * sm_scale : kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const float p = expf(s[r][j] - m_new);
        wp[r * kBlockK + lane + 32 * j] = p;
        psum += p;
      }
      l[r] = l[r] * corr + psum;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= corr;
      m[r] = m_new;
    }
    __syncwarp();

    // O += P V over the tile's keys
#pragma unroll 2
    for (int j = 0; j < kBlockK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < DPL; ++c) vv[t][c] = sv[(j + t) * LDV + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(wp + r * kBlockK + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          float t = acc[r][c];
          t = fmaf(pp.x, vv[0][c], t);
          t = fmaf(pp.y, vv[1][c], t);
          t = fmaf(pp.z, vv[2][c], t);
          t = fmaf(pp.w, vv[3][c], t);
          acc[r][c] = t;
        }
      }
    }
    __syncwarp();  // wp is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float denom = fmaxf(warp_sum(l[r]), 1e-30f);
    const int row = row0 + r;
    if (row < q_rows) {
      T* out = o + (((size_t)b * H + h) * Sq + q0 + row) * HD;
#pragma unroll
      for (int c = 0; c < DPL; ++c) store_as(out + lane + 32 * c, acc[r][c] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* q_offset, int B, int H, int K, int Sq, int Skv,
                   float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_offset, H, H / K, Sq, Skv, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd must be 64 or 128 (the wrapper pads
// other head dims).  All tensors contiguous on `device`; q_offset is (B,)
// int32.  Launches on `stream` without synchronising; returns the launch's
// cudaError_t (cudaErrorInvalidValue for an unsupported dtype or hd).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, const void* q_offset, int B, int H,
                               int K, int Sq, int Skv, int hd, int dtype,
                               float sm_scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* qo = static_cast<const int*>(q_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return (int)launch<float, 64>(q, k, v, o, qo, B, H, K, Sq, Skv, sm_scale, st);
  if (dtype == 0 && hd == 128)
    return (int)launch<float, 128>(q, k, v, o, qo, B, H, K, Sq, Skv, sm_scale, st);
  if (dtype == 1 && hd == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, qo, B, H, K, Sq, Skv, sm_scale, st);
  if (dtype == 1 && hd == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, qo, B, H, K, Sq, Skv, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
