// GQA flash-attention forward for Hopper (sm_90a), causal or not: bf16 on
// the tensor cores (mma.sync), fp32 on scalar FP32 FMA.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention/kernel.py::_flash_fwd_kernel
// (launched by flash_attention_fwd through pl.pallas_call).  Same function:
// q (B, H, Sq, hd), k/v (B, K, Skv, hd) with H = G*K; query head h reads KV
// head h / G; online softmax with fp32 m, l and acc; output in the input
// dtype.  Causal: query row i sits at absolute position q_offset[b] + i and
// key j is visible when j < Skv and j <= q_offset[b] + i.  Non-causal (the
// TPU kernel's causal=False, e.g. an encoder or cross-attention): every key
// j < Skv is visible and q_offset plays no part.  The mode is the template
// argument Causal of both kernels, so the causal instantiations carry no
// test of it in their inner loops.
//
// Structure, both types.  The TPU kernel carries acc/m/l in VMEM scratch
// across a sequential KV grid axis.  Hopper runs blocks in no order, so one
// block of four warps owns one (b, h, 64-row query tile) and loops over
// 64-key KV tiles itself.  Causal, it stops at the diagonal of its last
// valid row (q_offset[b] + last row), the TPU kernel's skip of blocks above
// the diagonal, and the blocks are issued heaviest tiles first; non-causal,
// it visits every KV tile, as the TPU kernel does, every block has the same
// work and the order means nothing.  Each warp owns 16 query rows.
//
// Bound on an H100 SXM (datasheet: 989e12 bf16 FLOP/s dense on the tensor
// cores, 3.35e12 B/s HBM3): max(flops / 989e12, bytes / 3.35e12) with
// flops = 2 * 2 * B * H * (visible (query, key) pairs) * hd and bytes =
// |q| + |k| + |v| + |o|.  Causal, the pairs are about half of Sq * Skv: at
// the serving shape (B=1, H=K=36, hd=64, S=1024, bf16) that is about 4.8
// GFLOP and 18.9 MB, and the bound is bytes (~5.6 us).  Non-causal, the
// pairs are all Sq * Skv: at whisper-large-v3's encoder (B=1, H=K=20,
// S=1500, hd=64, bf16) that is 4 * 20 * 1500^2 * 64 = 1.152e10 FLOP and
// 15.36 MB, and the bound is the FLOPs (~11.65 us against ~4.59 us for the
// bytes alone).
//
// bf16 (flash_fwd_bf16_kernel), FlashAttention-2 style, against the limits
// of the first, scalar design (fp32 FMA only, synchronous single-buffered
// loads, fp32 tiles of 66 KB in shared memory, probabilities through a
// shared buffer):
//   - S = Q K^T and O += P V run as mma.sync m16n8k16 bf16 with fp32
//     accumulators; Q's fragments are loaded once (ldmatrix) and held in
//     registers, K's come by ldmatrix and V's by ldmatrix.trans;
//   - K and V tiles stay bf16 in shared memory (9 KB each at hd 64) in a
//     two-stage ring filled by 16-byte cp.async.cg copies, so the next tile
//     loads while this one is computed; rows are padded by 16 bytes so that
//     ldmatrix's eight row addresses fall in distinct bank groups; rows past
//     Skv are zero-filled by the copy itself;
//   - the online softmax runs on the S accumulator in registers (row max and
//     sum over the four lanes of a quad), with sm_scale * log2(e) folded into
//     one multiply and 2^x from ex2.approx; P is packed to bf16 straight into
//     the A fragment of P V, so no probability goes through shared memory;
//   - masking is applied only to tiles that cross the warp's causal
//     diagonal (causal only) or the ragged end of Skv.
// 46 KB of shared memory at hd 64 (87 KB at hd 128).
//
// fp32 (flash_fwd_kernel) keeps the scalar IEEE FMA design: the fp32 path is
// held to 2e-6 against the plain version, which neither bf16 nor TF32
// products can meet.  K/V are staged as fp32 through shared memory, lane j
// holds keys j and j + 32 of the tile for S, and the probabilities go
// through a per-warp shared buffer for O += P V.
//
// Left for later: wgmma from shared memory, a TMA ring with mbarriers, and
// warp specialisation (a producer warp feeding consumer warpgroups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kBlockQ / kWarps;  // 16
constexpr int kKeysPerLane = kBlockK / 32;      // 2
constexpr float kNegInf = -1e30f;               // the reference's mask value

__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }

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

// One 16-byte vector of T as fp32 (the scalar kernel runs only for fp32).
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

template <typename T, int HD, bool Causal>
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
  // longest causal tiles first (non-causal: all tiles are equal)
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int K = H / G;
  const int kh = h / G;
  const int q0 = qtile * kBlockQ;
  const int q_rows = min(kBlockQ, Sq - q0);
  const int off = Causal ? q_offset[b] : 0;

  const T* qb = q + (((size_t)b * H + h) * Sq + q0) * HD;
  const T* kb = k + ((size_t)b * K + kh) * Skv * HD;
  const T* vb = v + ((size_t)b * K + kh) * Skv * HD;
  // causal: keys past the diagonal of the tile's last valid row are masked
  // for every row, so stop there
  const int kv_end = Causal ? min(Skv, off + q0 + q_rows) : Skv;

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
        const bool ok = kpos < Skv && (!Causal || kpos <= qpos);
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
                   int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  const auto kern = causal ? flash_fwd_kernel<T, HD, true> : flash_fwd_kernel<T, HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), q_offset, H, H / K, Sq, Skv, sm_scale);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores ------------------------------------------------

// Async copy of a 64-row tile of HD bf16 (row stride HD in global memory)
// into shared memory with row stride HD + 8; rows at or past rows_valid are
// zero-filled.
template <int HD>
__device__ __forceinline__ void cp_tile_bf16(__nv_bfloat16* __restrict__ dst,
                                             const __nv_bfloat16* __restrict__ src,
                                             int rows_valid, int tid) {
  constexpr int LD = HD + 8;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * CPR / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / CPR;
    const int c = (i % CPR) * 8;
    const bool ok = r < rows_valid;
    tc::cp_async16(dst + r * LD + c, ok ? src + (size_t)r * HD + c : src, ok ? 16 : 0);
  }
}

template <int HD>
constexpr size_t smem_bytes_bf16() {
  return sizeof(__nv_bfloat16) * (size_t)(kBlockQ + 4 * kBlockK) * (HD + 8);
}

template <int HD, bool Causal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      const int* __restrict__ q_offset, int H, int G, int Sq, int Skv,
                      float sm_scale) {
  constexpr int LD = HD + 8;
  constexpr int KSTEPS = HD / 16;  // k-steps of Q K^T
  constexpr int DTILES = HD / 8;   // n-tiles of the output
  constexpr int NTILES = kBlockK / 8;

  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sk = sq + kBlockQ * LD;  // [2][kBlockK][LD]
  __nv_bfloat16* sv = sk + 2 * kBlockK * LD;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  // longest causal tiles first (non-causal: all tiles are equal)
  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int K = H / G;
  const int kh = h / G;
  const int q0 = qtile * kBlockQ;
  const int q_rows = min(kBlockQ, Sq - q0);
  const int off = Causal ? q_offset[b] : 0;

  const __nv_bfloat16* qb = q + (((size_t)b * H + h) * Sq + q0) * HD;
  const __nv_bfloat16* kb = k + ((size_t)b * K + kh) * Skv * HD;
  const __nv_bfloat16* vb = v + ((size_t)b * K + kh) * Skv * HD;
  const int kv_end = Causal ? min(Skv, off + q0 + q_rows) : Skv;
  const int n_tiles = (kv_end + kBlockK - 1) / kBlockK;

  cp_tile_bf16<HD>(sq, qb, q_rows, tid);
  cp_tile_bf16<HD>(sk, kb, min(kBlockK, Skv), tid);
  cp_tile_bf16<HD>(sv, vb, min(kBlockK, Skv), tid);
  tc::cp_async_commit();

  // absolute positions of this thread's two rows, and of the warp's first
  const int warp_pos = off + q0 + warp * 16;
  const int pos_lo = warp_pos + g;
  const int pos_hi = pos_lo + 8;
  const float scale = sm_scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  uint32_t qf[KSTEPS][4];
  float acc[DTILES][4];
#pragma unroll
  for (int d = 0; d < DTILES; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;
  float l_lo = 0.f, l_hi = 0.f;  // this lane's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    if (t + 1 < n_tiles) {  // the next tile loads while this one is computed
      const int nk = k0 + kBlockK;
      const int st = (t + 1) & 1;
      cp_tile_bf16<HD>(sk + st * kBlockK * LD, kb + (size_t)nk * HD, min(kBlockK, Skv - nk), tid);
      cp_tile_bf16<HD>(sv + st * kBlockK * LD, vb + (size_t)nk * HD, min(kBlockK, Skv - nk), tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and Q) has landed
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        tc::ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks = sk + (t & 1) * kBlockK * LD;
    const __nv_bfloat16* vs = sv + (t & 1) * kBlockK * LD;

    // S = Q K^T: this warp's 16 rows x the tile's 64 keys
    float s[NTILES][4];
#pragma unroll
    for (int n = 0; n < NTILES; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int np = 0; np < NTILES / 2; ++np) {
        uint32_t kf[4];
        tc::ldmatrix_x4(kf, ks + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
        tc::mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        tc::mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale (log2 domain), mask where the tile crosses Skv or (causal) the
    // diagonal
    const bool masked = k0 + kBlockK > Skv || (Causal && k0 + kBlockK - 1 > warp_pos);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + t4 * 2 + (e & 1);
        const int pos = e < 2 ? pos_lo : pos_hi;
        float x = s[n][e] * scale;
        // two spellings, not `Causal && key > pos`: that one changes the
        // causal instantiation's code (143 registers against 134 at hd 64,
        // ~8% slower on an H100)
        if constexpr (Causal) {
          if (masked && (key >= Skv || key > pos)) x = kNegInf;
        } else {
          if (masked && key >= Skv) x = kNegInf;
        }
        s[n][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[n][0], s[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[n][2], s[n][3]));
    }
    const float mn_lo = fmaxf(m_lo, tc::quad_max(mx_lo));
    const float mn_hi = fmaxf(m_hi, tc::quad_max(mx_hi));
    const float corr_lo = tc::exp2_approx(m_lo - mn_lo);
    const float corr_hi = tc::exp2_approx(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      s[n][0] = tc::exp2_approx(s[n][0] - mn_lo);
      s[n][1] = tc::exp2_approx(s[n][1] - mn_lo);
      s[n][2] = tc::exp2_approx(s[n][2] - mn_hi);
      s[n][3] = tc::exp2_approx(s[n][3] - mn_hi);
      ps_lo += s[n][0] + s[n][1];
      ps_hi += s[n][2] + s[n][3];
    }
    l_lo = l_lo * corr_lo + ps_lo;
    l_hi = l_hi * corr_hi + ps_hi;
#pragma unroll
    for (int d = 0; d < DTILES; ++d) {
      acc[d][0] *= corr_lo;
      acc[d][1] *= corr_lo;
      acc[d][2] *= corr_hi;
      acc[d][3] *= corr_hi;
    }

    // O += P V: the S accumulators of keys 16kk..16kk+15, packed to bf16,
    // are the A fragment as they stand
#pragma unroll
    for (int kk = 0; kk < NTILES / 2; ++kk) {
      const uint32_t pa[4] = {tc::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              tc::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              tc::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              tc::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DTILES / 2; ++dp) {
        uint32_t vf[4];
        tc::ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                      dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        tc::mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }

  const float inv_lo = 1.f / fmaxf(tc::quad_sum(l_lo), 1e-30f);
  const float inv_hi = 1.f / fmaxf(tc::quad_sum(l_hi), 1e-30f);
  const int row_lo = warp * 16 + g;
  const int row_hi = row_lo + 8;
  __nv_bfloat16* ob = o + (((size_t)b * H + h) * Sq + q0) * HD;
#pragma unroll
  for (int d = 0; d < DTILES; ++d) {
    const int col = d * 8 + t4 * 2;
    if (row_lo < q_rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_lo * HD + col) =
          tc::pack_bf16(acc[d][0] * inv_lo, acc[d][1] * inv_lo);
    if (row_hi < q_rows)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_hi * HD + col) =
          tc::pack_bf16(acc[d][2] * inv_hi, acc[d][3] * inv_hi);
  }
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        const int* q_offset, int B, int H, int K, int Sq, int Skv,
                        int causal, float sm_scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes_bf16<HD>();
  const auto kern = causal ? flash_fwd_bf16_kernel<HD, true> : flash_fwd_bf16_kernel<HD, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockQ - 1) / kBlockQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), q_offset, H, H / K,
      Sq, Skv, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar FMA kernel), 1 = bfloat16 (tensor-core
// kernel).  hd must be 64 or 128 (the wrapper pads other head dims).
// causal: nonzero masks key j > q_offset[b] + i; zero attends over every
// key and reads no q_offset.  All tensors contiguous on `device` and 16-byte
// aligned; q_offset is (B,) int32.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (cudaErrorInvalidValue
// for an unsupported dtype or hd).
extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v,
                               void* o, const void* q_offset, int B, int H,
                               int K, int Sq, int Skv, int hd, int dtype,
                               int causal, float sm_scale, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* qo = static_cast<const int*>(q_offset);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64)
    return (int)launch<float, 64>(q, k, v, o, qo, B, H, K, Sq, Skv, causal, sm_scale, st);
  if (dtype == 0 && hd == 128)
    return (int)launch<float, 128>(q, k, v, o, qo, B, H, K, Sq, Skv, causal, sm_scale, st);
  if (dtype == 1 && hd == 64)
    return (int)launch_bf16<64>(q, k, v, o, qo, B, H, K, Sq, Skv, causal, sm_scale, st);
  if (dtype == 1 && hd == 128)
    return (int)launch_bf16<128>(q, k, v, o, qo, B, H, K, Sq, Skv, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
