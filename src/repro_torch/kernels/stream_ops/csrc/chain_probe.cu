// Measurement only: the launch floor and the dependent latency of each step
// of the stream kernels' chains.  chip_smoke.py (phase 9a) builds it beside
// the kernels and reads, for each kernel, a latency floor: its chain's
// steps times their measured cycles, at the SM clock nvidia-smi reports,
// plus an empty kernel's device time.  It includes the kernels' own
// source, so it times the very step functions they run.

#include "stream_ops.cu"

namespace {

// what chain_probe_kernel times, one dependent step at a time
enum Step {
  kServiceStep = 0,    // service_step: FFMA, compare, FADD, select
  kServiceFirstStep,   // service_first_step where 0 <= y < 1000: FFMA, compares
  kServiceFastStep,    // service_chain's bare step: FFMA, the wrap noted aside
  kVieteStep,          // viete_step: FADD, the IEEE square root, FMUL
  kFadd,               // a float32 add (the sums and the digest's scan)
  kDigestStep,         // an add and JAX's % 65521 (a digest output)
  kShflIadd,           // a shuffle and an integer add (parse_xml's reduction)
  kIadd,               // an integer add (parse_xml's per-lane sums)
  kFdiv,               // an IEEE float32 division (pi's last step)
  kShfl,               // a shuffle alone (parse_xml's next word, the digest's tile)
  kTagWord,            // parse_xml's word: successors, open_tags, byte_sum, adds
  kLoad,               // a global load that L1 does not keep (an L2 hit): a
                       // kernel's first read of its part
};

__global__ void empty_kernel() {}

// One warp runs `steps` dependent steps of kind `which`; lane 0 writes the
// clock64() cycles they took.  `zeros` holds 0s: kLoad chases its first
// entry, each load's address taken from the one before.
__global__ void chain_probe_kernel(int which, int steps, float seed, long long* cycles,
                                   float* sink, const int* zeros) {
  float x = seed, prod = seed;
  int n = threadIdx.x + 1;
  const int m = n;
  const long long t0 = clock64();
  switch (which) {
    case kServiceStep:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) x = service_step(x);
      break;
    case kServiceFirstStep:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) x = service_first_step(x);
      break;
    case kServiceFastStep: {
      bool wrapped = false;
#pragma unroll 16
      for (int k = 0; k < steps; ++k) {
        x = __fmaf_rn(x, kServiceMul, kServiceAdd);
        wrapped |= x >= kServiceMod;
      }
      n += wrapped;
      break;
    }
    case kVieteStep:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) viete_step(x, prod);
      break;
    case kFadd:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) x = __fadd_rn(x, seed);
      break;
    case kDigestStep:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) x = jax_mod(__fadd_rn(x, seed), kDigestModulus);
      break;
    case kShflIadd:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) n += __shfl_down_sync(kFull, n, 1);
      break;
    case kIadd:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) asm volatile("add.s32 %0, %0, %1;" : "+r"(n) : "r"(m));
      break;
    case kFdiv:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) x = __fdiv_rn(2.0f, x);
      break;
    case kShfl:
#pragma unroll 16
      for (int k = 0; k < steps; ++k) n = __shfl_down_sync(kFull, n, 1);
      break;
    case kLoad: {
      int j = 0;
#pragma unroll 16
      for (int k = 0; k < steps; ++k) j = __ldcg(zeros + j);
      n += j;
      break;
    }
    case kTagWord: {
      unsigned w = static_cast<unsigned>(n);
#pragma unroll 16
      for (int k = 0; k < steps; ++k)
        w += open_tags(w, successors(w, static_cast<unsigned>(m))) + byte_sum(w);
      n = static_cast<int>(w);
      break;
    }

    default:
      break;
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    cycles[0] = t1 - t0;
    sink[0] = x + prod + static_cast<float>(n);
  }
}

}  // namespace

extern "C" int repro_stream_empty(int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" int repro_chain_probe(int which, int steps, float seed, void* cycles, void* sink,
                                 const void* zeros, int device, void* stream) {
  if (steps < 1 || cycles == nullptr || sink == nullptr || zeros == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  chain_probe_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      which, steps, seed, static_cast<long long*>(cycles), static_cast<float*>(sink),
      static_cast<const int*>(zeros));
  return (int)cudaGetLastError();
}
