// Split-KV decode attention for Hopper (sm_90a): one query a sequence over
// a KV cache, read where it lies, up to each sequence's length.
//
// Replaces no TPU kernel: the reference decodes through plain jnp (its
// `_mha` over the cache, outside Pallas), and the port ran the same plain
// tensor code, `models/layers.py` `_mha_dense`.  That code widens all of K
// and V to fp32, transposes them for two einsums and scores every one of
// the cache's `S_max` positions before masking by the length: in a batched
// decode step of minicpm-2b (16 sequences of 4,136 positions, 36 heads of
// 64) that is 610 MB of fp32 written and read again per tensor per layer,
// for a cache whose live part is a fraction of it.  This kernel was added
// to take that step.
//
// Bound on an H100 SXM (3.35e12 B/s HBM3, 67e12 FP32 FLOP/s outside the
// tensor cores): each live key is one row of hd values, read once for all
// G query heads that share its KV head, for 4 G hd FLOPs.  At G = 1 that is
// about one FLOP a byte, so the bytes of the live cache bound it, and the
// design moves no other bytes:
//   - the cache is read in its (B, S_max, K, hd) layout through the strides
//     the caller gives: no transpose, no contiguous copy, no fp32 copy;
//   - a block reads keys only below its sequence's `kv_len` (read on the
//     device, so a captured CUDA graph replays with new lengths); a key's
//     row of one KV head (128-512 bytes) comes by 16-byte cp.async.cg copies
//     straight into shared memory, in a ring of two or three tiles of 32
//     keys, so that the next tiles load while one is computed; rows past the
//     range are zero-filled by the copy itself, and not read;
//   - flash-decoding: the grid is (sequence x KV head x head group, split),
//     one warp a block; the wrapper picks the split count from the batch,
//     the heads, S_max and the card's SMs so that the card fills whatever
//     the batch (minicpm-2b has 576 (sequence, KV head) pairs before any
//     split, nemotron-3-nano's 64 sequences x 2 KV heads 128).  A block
//     whose range starts at or past its sequence's length exits at once and
//     writes nothing; the combine kernel counts the live splits from the
//     length, so an empty split adds exactly nothing.
//
// The arithmetic is the plain version's: q scaled in its own dtype and then
// widened; scores, the softmax (an online one: a running max and sum a
// head, rescaled tile by tile, merged across splits by their maxima) and
// the P.V sums in fp32 scalar FMA (no bf16 or TF32 rounding of P or V); the
// output cast to q's dtype.  Skipping the masked keys changes nothing: the
// plain version gives them exp(-1e30 - max) = 0.  Of a sequence of length
// 0 (which no decode step sends) the output is 0.
//
//   decode_attn_split_kernel<T, HD, GB>: lane j of the warp scores key j of
//     the tile against the group's GB query heads (q in shared memory in
//     fp32, K rows padded by 16 bytes so that the lanes' 16-byte reads fall
//     in distinct banks); the tile's probabilities go through shared memory
//     and each lane accumulates two of every 64 output columns over the
//     tile's keys; the block writes its unnormalised sums, max and sum a head
//     to a workspace the wrapper allocates;
//   decode_attn_combine_kernel<T>: one block a (sequence, head) merges the
//     live splits and writes the output.
//
// Left for later: mma.sync for the scores of wide groups (G = 16), a TMA
// ring, and free slots sent with length 0 so that they read nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kTile = 32;          // keys a tile: one a lane in the score pass
constexpr int kSmemCap = 48 * 1024;  // static shared memory of a block

// 16 bytes of T widened to floats.
__device__ __forceinline__ void widen16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 two = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = two.x;
    f[2 * i + 1] = two.y;
  }
}

// Two neighbouring values of T widened to floats.
__device__ __forceinline__ float2 widen2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 widen2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T (round to nearest even), as a float.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

template <typename T, int HD>
struct Row {
  static constexpr int kElems = 16 / sizeof(T);   // values in a 16-byte chunk
  static constexpr int kChunks = HD / kElems;     // chunks in a row
  static constexpr int kPitch = HD + kElems;      // a row in shared memory, padded
  static constexpr int kPairs = (HD + 63) / 64;   // column pairs a lane owns in P.V
};

// Tiles in the ring: as many as fit beside q and the probabilities, at most 3.
template <typename T, int HD, int GB>
struct Ring {
  static constexpr int kFixed = (GB * HD + GB * kTile) * 4;
  static constexpr int kStage = 2 * kTile * Row<T, HD>::kPitch * (int)sizeof(T);
  static constexpr int kFit = (kSmemCap - kFixed) / kStage;
  static constexpr int kStages = kFit > 3 ? 3 : kFit;
};

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(32)
    decode_attn_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const long long* __restrict__ kv_len,
                             float* __restrict__ part_o, float* __restrict__ part_ml, int S, int K,
                             int G, int groups, int nsplit, int chunk, float scale,
                             long long ksb, long long kss, long long ksh, long long vsb,
                             long long vss, long long vsh) {
  using R = Row<T, HD>;
  constexpr int kStages = Ring<T, HD, GB>::kStages;
  static_assert(kStages >= 1, "a tile of K and V must fit in shared memory");
  __shared__ __align__(16) T kv_s[kStages][2][kTile * R::kPitch];
  __shared__ __align__(16) float q_s[GB][HD];
  __shared__ __align__(16) float p_s[GB][kTile];

  const int lane = threadIdx.x;
  const int split = blockIdx.y;
  const int hg = blockIdx.x % groups;
  const int kvh = (blockIdx.x / groups) % K;
  const int b = blockIdx.x / (groups * K);
  const long long len = kv_len[b];
  const int n = len <= 0 ? 0 : (len >= S ? S : (int)len);
  const int start = split * chunk;
  if (start >= n) return;  // an empty split: the combine counts it out
  const int end = min(start + chunk, n);
  const int H = K * G;
  const int g0 = hg * GB;  // the group's first head among the KV head's G
  const long long head0 = (long long)b * H + (long long)kvh * G + g0;

  // q scaled in its own dtype, then widened, as the plain version does
  for (int i = lane; i < GB * HD; i += 32) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = g0 + g < G ? round_as(to_float(q[(head0 + g) * HD + d]) * scale, q) : 0.f;
  }

  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;
  const int ntiles = (end - start + kTile - 1) / kTile;
  auto load = [&](int t) {
    const int key0 = start + t * kTile;
    T* ks = kv_s[t % kStages][0];
    T* vs = kv_s[t % kStages][1];
    for (int c = lane; c < kTile * R::kChunks; c += 32) {
      const int r = c / R::kChunks, e = (c % R::kChunks) * R::kElems;
      const bool live = key0 + r < end;
      const long long key = live ? key0 + r : start;  // a valid address; not read if dead
      tc::cp_async16(ks + r * R::kPitch + e, kb + key * kss + e, live ? 16 : 0);
      tc::cp_async16(vs + r * R::kPitch + e, vb + key * vss + e, live ? 16 : 0);
    }
  };

  float m[GB], l[GB], acc[GB][R::kPairs][2];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < R::kPairs; ++i) acc[g][i][0] = acc[g][i][1] = 0.f;
  }

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load(t);
    tc::cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    if (t + kStages - 1 < ntiles) load(t + kStages - 1);
    tc::cp_async_commit();
    tc::cp_async_wait<kStages - 1>();  // tile t has landed (this lane's copies)
    __syncwarp();                      // ... and every lane's
    const T* ks = kv_s[t % kStages][0];
    const T* vs = kv_s[t % kStages][1];

    // scores: lane j takes key j of the tile against the group's heads
    float s[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) s[g] = 0.f;
#pragma unroll
    for (int c = 0; c < R::kChunks; ++c) {
      float kf[R::kElems];
      widen16(ks + lane * R::kPitch + c * R::kElems, kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
#pragma unroll
        for (int e = 0; e < R::kElems; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(&q_s[g][c * R::kElems + e]);
          s[g] = fmaf(qv.x, kf[e], s[g]);
          s[g] = fmaf(qv.y, kf[e + 1], s[g]);
          s[g] = fmaf(qv.z, kf[e + 2], s[g]);
          s[g] = fmaf(qv.w, kf[e + 3], s[g]);
        }
      }
    }
    const bool live = start + t * kTile + lane < end;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float sg = live ? s[g] : -INFINITY;
      const float mn = fmaxf(m[g], warp_max(sg));  // finite: lane 0's key is live
      const float alpha = expf(m[g] - mn);         // 0 on the first tile
      const float p = expf(sg - mn);               // 0 past the range
      m[g] = mn;
      l[g] = l[g] * alpha + p;                     // this lane's share of the sum
#pragma unroll
      for (int i = 0; i < R::kPairs; ++i) {
        acc[g][i][0] *= alpha;
        acc[g][i][1] *= alpha;
      }
      p_s[g][lane] = p;
    }
    __syncwarp();

    // P.V: each lane its columns 64 i + 2 lane, + 1, over the tile's keys
    // (the zero-filled rows past the range have p = 0)
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float2 vv[R::kPairs];
#pragma unroll
      for (int i = 0; i < R::kPairs; ++i) {
        const int d = 64 * i + 2 * lane;
        vv[i] = d < HD ? widen2(vs + j * R::kPitch + d) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = p_s[g][j];
#pragma unroll
        for (int i = 0; i < R::kPairs; ++i) {
          acc[g][i][0] = fmaf(p, vv[i].x, acc[g][i][0]);
          acc[g][i][1] = fmaf(p, vv[i].y, acc[g][i][1]);
        }
      }
    }
    __syncwarp();  // the ring slot and p_s are written again next
  }

#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const float lg = warp_sum(l[g]);
    if (g0 + g >= G) continue;
    const long long row = (head0 + g) * nsplit + split;
    float* po = part_o + row * HD;
#pragma unroll
    for (int i = 0; i < R::kPairs; ++i) {
      const int d = 64 * i + 2 * lane;
      if (d < HD) *reinterpret_cast<float2*>(po + d) = make_float2(acc[g][i][0], acc[g][i][1]);
    }
    if (lane == 0) *reinterpret_cast<float2*>(part_ml + 2 * row) = make_float2(m[g], lg);
  }
}

// One block a (sequence, head): the live splits' sums, each rescaled from
// its own max to their common one.
template <typename T>
__global__ void __launch_bounds__(128)
    decode_attn_combine_kernel(const float* __restrict__ part_o,
                               const float* __restrict__ part_ml,
                               const long long* __restrict__ kv_len, T* __restrict__ out, int S,
                               int H, int HD, int nsplit, int chunk) {
  const long long bh = blockIdx.x;
  const long long len = kv_len[bh / H];
  const int n = len <= 0 ? 0 : (len >= S ? S : (int)len);
  const int live = (n + chunk - 1) / chunk;
  const float* ml = part_ml + bh * nsplit * 2;
  float mx = -INFINITY;
  for (int s = 0; s < live; ++s) mx = fmaxf(mx, ml[2 * s]);
  float sum = 0.f;
  for (int s = 0; s < live; ++s) sum += ml[2 * s + 1] * expf(ml[2 * s] - mx);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < live; ++s)
      o = fmaf(part_o[(bh * nsplit + s) * HD + d], expf(ml[2 * s] - mx), o);
    store(out + bh * HD + d, live ? o / sum : 0.f);
  }
}

template <typename T, int HD, int GB>
cudaError_t launch(const T* q, const T* k, const T* v, const long long* kv_len, float* part_o,
                   float* part_ml, T* out, int B, int S, int K, int G, int groups, int nsplit,
                   int chunk, float scale, long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh, cudaStream_t stream) {
  decode_attn_split_kernel<T, HD, GB><<<dim3(B * K * groups, nsplit), 32, 0, stream>>>(
      q, k, v, kv_len, part_o, part_ml, S, K, G, groups, nsplit, chunk, scale, ksb, kss, ksh,
      vsb, vss, vsh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attn_combine_kernel<T><<<B * K * G, 128, 0, stream>>>(part_o, part_ml, kv_len, out, S,
                                                               K * G, HD, nsplit, chunk);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_group(int gb, const T* q, const T* k, const T* v, const long long* kv_len,
                         float* part_o, float* part_ml, T* out, int B, int S, int K, int G,
                         int groups, int nsplit, int chunk, float scale, long long ksb,
                         long long kss, long long ksh, long long vsb, long long vss,
                         long long vsh, cudaStream_t st) {
#define REPRO_DECODE_GB(N)                                                                  \
  if (gb == N)                                                                              \
    return launch<T, HD, N>(q, k, v, kv_len, part_o, part_ml, out, B, S, K, G, groups,      \
                            nsplit, chunk, scale, ksb, kss, ksh, vsb, vss, vsh, st);
  REPRO_DECODE_GB(1)
  REPRO_DECODE_GB(4)
  REPRO_DECODE_GB(8)
  REPRO_DECODE_GB(16)
#undef REPRO_DECODE_GB
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_width(int hd, int gb, const void* q, const void* k, const void* v,
                         const long long* kv_len, float* part_o, float* part_ml, void* out,
                         int B, int S, int K, int G, int groups, int nsplit, int chunk,
                         float scale, long long ksb, long long kss, long long ksh, long long vsb,
                         long long vss, long long vsh, cudaStream_t st) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
#define REPRO_DECODE_HD(N)                                                                  \
  if (hd == N)                                                                              \
    return launch_group<T, N>(gb, qt, kt, vt, kv_len, part_o, part_ml, ot, B, S, K, G,      \
                              groups, nsplit, chunk, scale, ksb, kss, ksh, vsb, vss, vsh, st);
  REPRO_DECODE_HD(64)
  REPRO_DECODE_HD(96)
  REPRO_DECODE_HD(112)
  REPRO_DECODE_HD(128)
#undef REPRO_DECODE_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, 1, K G, hd) contiguous; k, v (B, S, K, hd) with the given strides
// in elements (the last dimension contiguous; 16-byte aligned rows);
// kv_len (B,) int64; part_o (B, K G, nsplit, hd) and part_ml (B, K G,
// nsplit, 2) fp32 scratch; out (B, 1, K G, hd), written, in q's dtype.
// dtype: 0 = float32, 1 = bfloat16; hd 64, 96, 112 or 128; gb (heads a
// block takes) 1, 4, 8 or 16, groups = ceil(G / gb); nsplit splits of
// `chunk` keys (a multiple of 32).  Launches both kernels on `stream`
// without synchronising; returns the first launch's cudaError_t
// (cudaErrorInvalidValue for an unsupported dtype, hd or gb).
extern "C" int repro_decode_attn(const void* q, const void* k, const void* v, const void* kv_len,
                                 void* part_o, void* part_ml, void* out, int B, int S, int K,
                                 int G, int hd, int gb, int groups, int nsplit, int chunk,
                                 long long ksb, long long kss, long long ksh, long long vsb,
                                 long long vss, long long vsh, float scale, int dtype,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const auto* lens = static_cast<const long long*>(kv_len);
  auto* po = static_cast<float*>(part_o);
  auto* pml = static_cast<float*>(part_ml);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_width<float>(hd, gb, q, k, v, lens, po, pml, out, B, S, K, G, groups,
                                    nsplit, chunk, scale, ksb, kss, ksh, vsb, vss, vsh, st);
  if (dtype == 1)
    return (int)launch_width<__nv_bfloat16>(hd, gb, q, k, v, lens, po, pml, out, B, S, K, G,
                                            groups, nsplit, chunk, scale, ksb, kss, ksh, vsb,
                                            vss, vsh, st);
  return (int)cudaErrorInvalidValue;
}
