// The streaming runtime's operator bodies for Hopper (sm_90a): one launch
// per routed part of a frame (B tuples of one task's slot group).
//
// Replaces the XLA programs the reference jits per (task, slot) (not Pallas
// kernels), the bodies of src/repro/runtime/operators.py:
//   _op_parse_xml (:24)        -> parse_xml_kernel
//   _op_pi (:37)               -> viete_pi_kernel       (a 14-step fori_loop)
//   _op_batch_file_write (:52) -> rolling_digest_kernel
//   _op_external_service (:60) -> external_service_kernel (a 64-step fori_loop)
// Eager PyTorch would run the two fori_loops as ~60 and ~200 launches a
// call; each body here is one launch, the port's counterpart of one
// compiled program per operator call.
//
// Numerics are bit for bit those of the reference's programs as XLA
// compiles them for the CPU (ref.py says how they were read):
//   * the service's x * 1.000001 + 0.5 is one fused multiply-add
//     (__fmaf_rn): XLA contracts it on a host with FMA;
//   * its sum takes XLA's order: left to right up to 32 values, else
//     windows of 32 (padding split evenly, the odd element high), each in
//     order, then the window sums the same way;
//   * the digest's running sum takes XLA's blocked order: tiles of 16, each
//     scanned in order, plus the exclusive prefix of the tile totals,
//     scanned the same way, recursively;
//   * JAX's % is an exact fmodf plus the modulus where the remainder is
//     negative (the moduli are positive);
//   * every other float32 step is one correctly rounded operation.
// The byte counts are exact integers; the checksum is int32 (the
// reference's uint32; its largest value, 126 x L, fits).
//
// What bounds them: at the runtime's part sizes (B <= 32 tuples of 256
// bytes) each moves a few KB and does a few thousand operations, far
// below a microsecond of the card's memory or arithmetic.  Every launch is
// bound by its fixed cost and by its dependent chain: 64 steps of the
// service, 14 of Viète's product, B adds of the digest.  So each design
// keeps the chain short and the launch small: one warp a call where the
// work is one chain, a warp per payload row for the tag scan, a thread per
// tuple for pi.  Entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;          // parse_xml: one warp per row
constexpr int kPiThreads = 128;
constexpr int kSumWindow = 32;            // XLA's tree-reduction window
constexpr int kScanTile = 16;             // XLA's blocked-scan tile
constexpr int kMaxLevels = 9;             // 16^8 > 2^31 tuples
constexpr float kDigestModulus = 65521.0f;
constexpr float kServiceMul = 1.000001f;  // 1 + 2^-20 as float32
constexpr float kServiceAdd = 0.5f;
constexpr float kServiceMod = 1000.0f;

// JAX's % for a positive modulus: fmodf is exact; the fix-up add rounds.
__device__ __forceinline__ float jax_mod(float x, float m) {
  const float r = fmodf(x, m);
  return r < 0.0f ? __fadd_rn(r, m) : r;
}

// The service chain's step 1, from any key: a fused multiply-add, then
// JAX's % (fmodf and the sign fix-up), which leaves y as it is where
// 0 <= y < 1000 (the runtime's keys: sums of values in [0, 1)).
__device__ __forceinline__ float service_first_step(float x) {
  const float y = __fmaf_rn(x, kServiceMul, kServiceAdd);
  return y >= 0.0f && y < kServiceMod ? y : jax_mod(y, kServiceMod);
}

// One of steps 2..work, from x in [0, 1000]: y = fma(x, c, 0.5) lies in
// [0.5, 1000.501], where fmod(y, 1000) is y - 1000 for y >= 1000 (exact by
// Sterbenz's lemma) and y below, and no sign fix-up applies.  An FFMA, a
// compare and an FADD with a select; NaN passes through as from fmodf.
__device__ __forceinline__ float service_step(float x) {
  const float y = __fmaf_rn(x, kServiceMul, kServiceAdd);
  return y >= kServiceMod ? __fsub_rn(y, kServiceMod) : y;
}

// Steps 2..work.  Below 1000 a step is the multiply-add alone, and y grows
// by about 0.5 a step, so most chains never wrap: run the bare FFMAs,
// noting off the chain whether any result reached 1000, and only then run
// the steps again with their wrap (service_step).  Both give the same
// bits: without a wrap every step's fmod leaves y as it is.
__device__ __forceinline__ float service_chain(float x, int work) {
  float y = x;
  bool wrapped = false;
#pragma unroll 8
  for (int k = 1; k < work; ++k) {
    y = __fmaf_rn(y, kServiceMul, kServiceAdd);
    wrapped |= y >= kServiceMod;
  }
  if (!wrapped) return y;
  for (int k = 1; k < work; ++k) x = service_step(x);
  return x;
}

// One step of Viète's product.  a stays in [sqrt(2), 2], so a / 2 is
// exact and equals a * 0.5 bit for bit.
__device__ __forceinline__ void viete_step(float& a, float& prod) {
  a = __fsqrt_rn(__fadd_rn(2.0f, a));
  prod = __fmul_rn(prod, __fmul_rn(a, 0.5f));
}

__global__ void parse_xml_kernel(const uint8_t* __restrict__ payload, int B, int L,
                                 int* __restrict__ tags, int* __restrict__ checksum) {
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  if (row >= B) return;                   // the whole warp leaves together
  const uint8_t* p = payload + static_cast<size_t>(row) * L;
  int open = 0, sum = 0;
  for (int j = lane; j < L; j += kWarp) {
    const int c = p[j];
    const int next = p[j + 1 < L ? j + 1 : 0];   // cyclic: jnp.roll(payload, -1)
    open += (c == '<') & (next != '/');
    sum += c;
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    open += __shfl_down_sync(kFull, open, off);
    sum += __shfl_down_sync(kFull, sum, off);
  }
  if (lane == 0) {
    tags[row] = open;
    checksum[row] = sum;
  }
}

// One thread per tuple.  The result does not depend on the tuple's values
// (the reference computes the same product for each), but every tuple
// runs its own chain, as the reference's vectorised loop does: 14
// dependent steps of an add, a square root and two multiplies (the
// halving a multiply: viete_step); the final 2 / prod stays a rounded
// division.
__global__ void viete_pi_kernel(int B, int iterations, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float a = __fsqrt_rn(2.0f);
  float prod = __fmul_rn(a, 0.5f);
  for (int k = 0; k < iterations - 1; ++k) viete_step(a, prod);
  out[i] = __fdiv_rn(2.0f, prod);
}

// The running sum in XLA's blocked order, one warp, a lane per tile.  A
// part of at most 16 is one tile, scanned by lane 0.  For a longer one,
// level 0 is the part and level k + 1 holds the totals of level k's tiles
// (a tile's total is its in-tile prefix at its end), in shared memory,
// until a level has at most 16 values.  Lane 0 scans that level in place;
// then, from the level below it down to the part, each tile's in-tile
// prefix gets the inclusive sum of the tiles before it (0 for the first)
// added, in place, and the part's are written out under JAX's %.  The pads
// past a level's end are zeros, which leave every sum as it is.
__global__ void rolling_digest_kernel(const void* __restrict__ x, int is_int, int B,
                                      float* __restrict__ out) {
  extern __shared__ float sums[];
  const int lane = threadIdx.x;
  auto value = [&](int i) {
    return is_int ? __int2float_rn(static_cast<const int*>(x)[i])
                  : static_cast<const float*>(x)[i];
  };
  if (B <= kScanTile) {
    if (lane == 0) {
      float v[kScanTile];
#pragma unroll
      for (int i = 0; i < kScanTile; ++i) v[i] = i < B ? value(i) : 0.0f;
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < kScanTile; ++i) {
        acc = __fadd_rn(acc, v[i]);
        if (i < B) out[i] = jax_mod(acc, kDigestModulus);
      }
    }
    return;
  }
  // level k's length and, for k >= 1, its start in `sums`
  int len[kMaxLevels], start[kMaxLevels];
  len[0] = B;
  start[0] = 0;
  int top = 0;
  while (len[top] > kScanTile) {
    len[top + 1] = (len[top] + kScanTile - 1) / kScanTile;
    start[top + 1] = top == 0 ? 0 : start[top] + len[top];
    ++top;
  }
  auto level_at = [&](int k, int i) { return k == 0 ? value(i) : sums[start[k] + i]; };
  for (int k = 1; k <= top; ++k) {        // down: the totals of level k - 1's tiles
    for (int t = lane; t < len[k]; t += kWarp) {
      float acc = 0.0f;
      for (int j = 0; j < kScanTile; ++j) {
        const int i = t * kScanTile + j;
        if (i < len[k - 1]) acc = __fadd_rn(acc, level_at(k - 1, i));
      }
      sums[start[k] + t] = acc;
    }
    __syncwarp();
  }
  if (lane == 0) {                        // the top level, in place
    float acc = 0.0f;
    for (int i = 0; i < len[top]; ++i) {
      acc = __fadd_rn(acc, sums[start[top] + i]);
      sums[start[top] + i] = acc;
    }
  }
  __syncwarp();
  for (int k = top - 1; k >= 0; --k) {    // up: add the tiles before each tile
    for (int t = lane; t < len[k + 1]; t += kWarp) {
      const float before = t > 0 ? sums[start[k + 1] + t - 1] : 0.0f;
      float acc = 0.0f;
      for (int j = 0; j < kScanTile; ++j) {
        const int i = t * kScanTile + j;
        if (i >= len[k]) break;
        acc = __fadd_rn(acc, level_at(k, i));
        const float s = __fadd_rn(acc, before);
        if (k == 0) out[i] = jax_mod(s, kDigestModulus);
        else sums[start[k] + i] = s;
      }
    }
    __syncwarp();
  }
}

// One warp.  Each lane loads one value of a part of at most 32, and every
// lane sums all of them in order through shuffles, so every lane holds the
// key without a barrier or shared memory.  A longer part is summed in
// XLA's windows of 32 (a lane per window) into `out`, which serves as
// scratch until the result is written, level by level until at most 32
// sums remain.  Then every lane runs the chain (service_first_step,
// service_chain).
__global__ void external_service_kernel(const float* __restrict__ v, int B, int work,
                                        float* out) {
  const int lane = threadIdx.x;
  const float* src = v;
  float* scratch = out;
  int n = B;
  while (n > kSumWindow) {
    const int windows = (n + kSumWindow - 1) / kSumWindow;
    const int lo = (windows * kSumWindow - n) / 2;   // leading pads
    for (int w = lane; w < windows; w += kWarp) {
      float acc = 0.0f;
      for (int j = 0; j < kSumWindow; ++j) {
        const int i = w * kSumWindow + j - lo;
        if (i >= 0 && i < n) acc = __fadd_rn(acc, src[i]);
      }
      scratch[w] = acc;
    }
    __syncwarp();
    src = scratch;
    scratch += windows;
    n = windows;
  }
  const float mine = lane < n ? src[lane] : 0.0f;
  float part[kWarp];                        // the shuffles issued together
#pragma unroll
  for (int i = 0; i < kWarp; ++i) part[i] = __shfl_sync(kFull, mine, i);
  float x = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarp; ++i) {
    if (i >= n) break;
    x = __fadd_rn(x, part[i]);
  }
  if (work > 0) x = service_chain(service_first_step(x), work);
  __syncwarp();                             // every lane is done with scratch
  for (int i = lane; i < B; i += kWarp) out[i] = x;
}

// Make `device` current for the launch; a thread's current device is read
// first, since setting it costs more than reading it.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" int repro_parse_xml(const void* payload, int B, int L, void* tags, void* checksum,
                               int device, void* stream) {
  if (B < 1 || L < 1 || payload == nullptr || tags == nullptr || checksum == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kRowsPerBlock - 1) / kRowsPerBlock;
  parse_xml_kernel<<<blocks, kRowsPerBlock * kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(payload), B, L, static_cast<int*>(tags),
      static_cast<int*>(checksum));
  return (int)cudaGetLastError();
}

extern "C" int repro_viete_pi(int B, int iterations, void* out, int device, void* stream) {
  if (B < 1 || iterations < 1 || out == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + kPiThreads - 1) / kPiThreads;
  viete_pi_kernel<<<blocks, kPiThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      B, iterations, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Shared bytes the digest needs for a part of B: the tile totals of every
// level above the part.
extern "C" int repro_rolling_digest_shared_bytes(int B) {
  long long total = 0;
  for (long long n = B; n > kScanTile;) {
    n = (n + kScanTile - 1) / kScanTile;
    total += n;
  }
  return static_cast<int>(total * static_cast<long long>(sizeof(float)));
}

extern "C" int repro_rolling_digest(const void* x, int is_int, int B, void* out, int device,
                                    void* stream) {
  if (B < 1 || x == nullptr || out == nullptr || (is_int != 0 && is_int != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  rolling_digest_kernel<<<1, kWarp, repro_rolling_digest_shared_bytes(B),
                          static_cast<cudaStream_t>(stream)>>>(x, is_int, B,
                                                               static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int repro_external_service(const void* v, int B, int work, void* out, int device,
                                      void* stream) {
  if (B < 1 || work < 0 || v == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  external_service_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), B, work, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
