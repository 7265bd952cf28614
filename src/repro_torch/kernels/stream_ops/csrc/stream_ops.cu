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
// Numerics are the reference's on the CPU: every float32 product, sum,
// quotient and square root is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so nvcc cannot contract x * c + d into an FMA
// (XLA on the CPU does not).  JAX's % is fmod with a sign fix that never
// fires on these non-negative operands, and fmodf is exact.  The running
// sum of the digest is one thread walking the part left to right, the
// reference's order.  The byte counts are exact integers; the checksum is
// int32 (the reference's uint32; its largest value, 126 x L, fits).
//
// What bounds them: at the runtime's part sizes (B <= 16 tuples of 256
// bytes) each moves a few KB and does a few thousand operations, far
// below a microsecond of the card's memory or arithmetic; every launch is
// bound by its fixed cost, and the chains (64 dependent fmodf steps, B
// dependent adds) by their latency.  So each design is the simplest that
// is right: one warp per payload row (byte loads strided over the lanes, a
// shuffle sum), one thread per tuple for pi, one thread for the running
// sum, one block for the service (a tree sum, then one thread's chain).
// Entry points return cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;          // parse_xml: one warp per row
constexpr int kPiThreads = 128;
constexpr int kServiceThreads = 256;      // a power of two (the tree sum)
constexpr float kDigestModulus = 65521.0f;
constexpr float kServiceMul = 1.000001f;
constexpr float kServiceAdd = 0.5f;
constexpr float kServiceMod = 1000.0f;

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
    open += __shfl_down_sync(0xffffffffu, open, off);
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) {
    tags[row] = open;
    checksum[row] = sum;
  }
}

__global__ void viete_pi_kernel(int B, int iterations, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  float a = __fsqrt_rn(2.0f);
  float prod = __fdiv_rn(a, 2.0f);
  for (int k = 0; k < iterations - 1; ++k) {
    a = __fsqrt_rn(__fadd_rn(2.0f, a));
    prod = __fmul_rn(prod, __fdiv_rn(a, 2.0f));
  }
  out[i] = __fdiv_rn(2.0f, prod);
}

__global__ void rolling_digest_kernel(const void* __restrict__ x, int is_int, int B,
                                      float* __restrict__ out) {
  float acc = 0.0f;
  for (int i = 0; i < B; ++i) {
    const float v = is_int ? __int2float_rn(static_cast<const int*>(x)[i])
                           : static_cast<const float*>(x)[i];
    acc = __fadd_rn(acc, v);
    out[i] = fmodf(acc, kDigestModulus);
  }
}

__global__ void external_service_kernel(const float* __restrict__ v, int B, int work,
                                        float* __restrict__ out) {
  __shared__ float partial[kServiceThreads];
  __shared__ float result;
  float s = 0.0f;
  for (int i = threadIdx.x; i < B; i += kServiceThreads) s = __fadd_rn(s, v[i]);
  partial[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kServiceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
      partial[threadIdx.x] = __fadd_rn(partial[threadIdx.x], partial[threadIdx.x + stride]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float key = partial[0];
    for (int k = 0; k < work; ++k)
      key = fmodf(__fadd_rn(__fmul_rn(key, kServiceMul), kServiceAdd), kServiceMod);
    result = key;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += kServiceThreads) out[i] = result;
}

cudaError_t use_device(int device) { return cudaSetDevice(device); }

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

extern "C" int repro_rolling_digest(const void* x, int is_int, int B, void* out, int device,
                                    void* stream) {
  if (B < 1 || x == nullptr || out == nullptr || (is_int != 0 && is_int != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  rolling_digest_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      x, is_int, B, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int repro_external_service(const void* v, int B, int work, void* out, int device,
                                      void* stream) {
  if (B < 1 || work < 0 || v == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  external_service_kernel<<<1, kServiceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), B, work, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
