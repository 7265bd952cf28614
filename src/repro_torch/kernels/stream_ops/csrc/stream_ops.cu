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
// reference's uint32; its largest value, 255 x L for a row of L bytes,
// fits for L <= 8,421,504).
//
// What bounds them: at the runtime's part sizes (B <= 32 tuples of 256
// bytes) each moves a few KB and does a few thousand operations, far
// below a microsecond of the card's memory or arithmetic.  Every launch is
// bound by its fixed cost and by its dependent chain: 64 steps of the
// service, 14 of Viete's product, the digest's in-tile adds and one %.
// So each design keeps the chain short and the launch small:
//   * parse_xml: a row in 16-byte chunks (LDG.128), a lane a chunk, 16
//     lanes a row of 256 bytes; each word's bytes tested at once (exact
//     zero-byte bit tricks, __popc, __dp4a), the successor of a lane's last
//     byte from the next lane by one shuffle, no lane branching, tags and
//     checksum reduced side by side in log2(lanes) shuffle steps.  Rows
//     that are not 16-byte aligned or whose length is not a multiple of 16
//     take a byte path of the same kernel (a warp a row, a byte a lane);
//   * viete_pi: a thread per tuple;
//   * rolling_digest: 16 lanes a tile, each lane its own in-tile prefix
//     (predicated adds) and its own % and store; a part of up to 16384 in
//     one block, the levels of tile totals in shared memory, warps with no
//     tile of a level skipping it; a longer part level by level through
//     device memory (scratch from the wrapper, sized by
//     repro_rolling_digest_scratch_floats), a kernel a pass;
//   * external_service: one warp, the sum through shuffles.
// Entry points return cudaGetLastError() after their launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 8;          // parse_xml's byte path: a warp a row
constexpr int kParseThreads = 256;        // parse_xml's vector path: a block
constexpr int kChunk = 16;                // bytes a lane loads at once (uint4)
constexpr int kPiThreads = 128;
constexpr int kSumWindow = 32;            // XLA's tree-reduction window
constexpr int kScanTile = 16;             // XLA's blocked-scan tile
constexpr int kMaxLevels = 9;             // 16^8 > 2^31 tuples
constexpr int kDigestThreads = 1024;      // 64 tiles a block
constexpr int kDigestOffsetThreads = 256;
// The longest part one block takes whole, and the shared floats its levels
// of tile totals take: 16384 -> 1024 -> 64 -> 4.
constexpr int kDigestReach = kScanTile * kDigestThreads;
constexpr int kDigestShared = 1024 + 64 + 4;
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

// 0x80 in each byte of x that is zero, else 0: exact on every byte (the
// add sets a byte's high bit unless its low seven bits are 0, and carries
// into no other byte).
__device__ __forceinline__ unsigned zero_bytes(unsigned x) {
  return ~(((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
}

// The open tags among a word's four bytes: a byte '<' whose successor (the
// same byte of `after`) is not '/'.
__device__ __forceinline__ int open_tags(unsigned w, unsigned after) {
  return __popc(zero_bytes(w ^ 0x3c3c3c3cu) & ~zero_bytes(after ^ 0x2f2f2f2fu));
}

// Each byte's successor in memory order: bytes 1-3 of w, byte 0 of next.
__device__ __forceinline__ unsigned successors(unsigned w, unsigned next) {
  return __byte_perm(w, next, 0x4321);
}

// The byte sum of a word, unsigned: one IDP4A.
__device__ __forceinline__ int byte_sum(unsigned w) { return __dp4a(w, 0x01010101u, 0u); }

// Vector path: a row of L bytes (L % 16 == 0, the payload 16-byte
// aligned) is L / 16 chunks over `lanes` lanes (a power of two, at most
// 32), chunk c on lane c % lanes; a warp holds 32 / lanes rows.  A chunk's
// last byte takes its successor from the first word of the next chunk: the
// next lane's (one shuffle), the next pass's where this lane is the row's
// last (a 4-byte load), or the row's byte 0 after the row's last chunk
// (cyclic: jnp.roll(payload, -1)).  Every lane of a warp runs the same
// passes and shuffles; lanes past the part or the row hold zeros, which
// count nothing, so no lane branches.
__device__ __forceinline__ void parse_rows_vector(const uint8_t* __restrict__ payload, int B,
                                                  int L, int lanes, int* __restrict__ tags,
                                                  int* __restrict__ checksum) {
  const int shift = __ffs(lanes) - 1;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (((tid & ~(kWarp - 1)) >> shift) >= B) return;   // the warp's rows are past the part
  const int row = tid >> shift;
  const int lane = tid & (lanes - 1);
  const bool active = row < B;
  const int chunks = L / kChunk;
  const uint4* p = reinterpret_cast<const uint4*>(payload) +
                   static_cast<size_t>(active ? row : 0) * chunks;
  unsigned first = 0;
  int open = 0, sum = 0;
  for (int base = 0; base < chunks; base += lanes) {
    const int c = base + lane;
    const bool mine = active && c < chunks;
    const uint4 w = mine ? __ldg(p + c) : make_uint4(0u, 0u, 0u, 0u);
    if (base == 0) first = __shfl_sync(kFull, w.x, 0, lanes);
    unsigned next = __shfl_down_sync(kFull, w.x, 1, lanes);
    if (mine && lane == lanes - 1 && c + 1 < chunks)
      next = __ldg(reinterpret_cast<const unsigned*>(p + c + 1));
    next = c == chunks - 1 ? first : next;
    open += (open_tags(w.x, successors(w.x, w.y)) + open_tags(w.y, successors(w.y, w.z))) +
            (open_tags(w.z, successors(w.z, w.w)) + open_tags(w.w, successors(w.w, next)));
    sum += (byte_sum(w.x) + byte_sum(w.y)) + (byte_sum(w.z) + byte_sum(w.w));
  }
  for (int off = lanes / 2; off > 0; off >>= 1) {
    open += __shfl_down_sync(kFull, open, off, lanes);
    sum += __shfl_down_sync(kFull, sum, off, lanes);
  }
  if (active && lane == 0) {
    tags[row] = open;
    checksum[row] = sum;
  }
}

// Byte path, for any row: a warp a row, each lane every 32nd byte.
__device__ __forceinline__ void parse_rows_bytes(const uint8_t* __restrict__ payload, int B,
                                                 int L, int* __restrict__ tags,
                                                 int* __restrict__ checksum) {
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

template <bool kVector>
__global__ void parse_xml_kernel(const uint8_t* __restrict__ payload, int B, int L, int lanes,
                                 int* __restrict__ tags, int* __restrict__ checksum) {
  if constexpr (kVector)
    parse_rows_vector(payload, B, L, lanes, tags, checksum);
  else
    parse_rows_bytes(payload, B, L, tags, checksum);
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

// A digest level's element as float32: an int32 column's values are
// converted once, as XLA's convert.
__device__ __forceinline__ float as_float(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float as_float(float v) { return v; }

// A digest output: JAX's % 65521 of the running sum at level 0; a scanned
// tile total as it is above.
template <bool kFinal>
__device__ __forceinline__ float finish(float s) {
  return kFinal ? jax_mod(s, kDigestModulus) : s;
}

// The in-tile inclusive prefix of lane `lane` (0-15) of a tile whose 16
// values sit one a lane in a 16-lane segment: the lane adds v_0 .. v_lane
// left to right from 0, the very rounded adds of the sequential scan, so
// the bits are the same.  Lanes past `last` (the tile's last value) stop
// there: only the part's last tile is short, and its total is never an
// offset.  The shuffles come first, for the whole warp; the adds are
// predicated, 16 for every lane, since a branch a step costs more.
__device__ __forceinline__ float tile_prefix(float v, int lane, int last) {
  float t[kScanTile];
#pragma unroll
  for (int k = 0; k < kScanTile; ++k) t[k] = __shfl_sync(kFull, v, k, kScanTile);
  const int stop = min(lane, last);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kScanTile; ++k) acc = k <= stop ? __fadd_rn(acc, t[k]) : acc;
  return acc;
}

// The values tile t of a level of n holds, less one: its last lane.
__device__ __forceinline__ int tile_last(long long n, long long t) {
  const long long left = n - t * kScanTile;
  return static_cast<int>(left < kScanTile ? left : kScanTile) - 1;
}

// The running sum of a level of n <= kDigestReach values in XLA's blocked
// order, in one block (16 lanes a tile): level 0 is src, level k + 1 the
// totals of level k's tiles, in shared memory, until a level holds at most
// 16.  Down: each level's in-tile prefixes (level 0's kept in a register
// where the block covers the part in one pass, else in dest) and tile
// totals; the top level is scanned alone (no offset, as a scan of <= 16
// values is).  Up: each element gets prefix + offset, one rounding, the
// offset the scanned total of the tiles before its tile (0 for the first);
// level 0's go to dest under finish.  dest may be src (a level of scratch).
template <typename T, bool kFinal>
__global__ void __launch_bounds__(kDigestThreads)
    digest_block_kernel(const T* src, int n, float* dest) {
  __shared__ float lvl[kDigestShared];
  const int lane = threadIdx.x % kScanTile;
  const int group = threadIdx.x / kScanTile;
  const int groups = blockDim.x / kScanTile;
  if (n <= kScanTile) {                   // one tile: the sequential scan
    const float v = threadIdx.x < n ? as_float(src[threadIdx.x]) : 0.0f;
    const float acc = tile_prefix(v, lane, n - 1);
    if (threadIdx.x < n) dest[threadIdx.x] = finish<kFinal>(acc);
    return;
  }
  int len[kMaxLevels], start[kMaxLevels];
  int top = 0;
  len[0] = n;
  start[1] = 0;
  while (len[top] > kScanTile) {
    len[top + 1] = (len[top] + kScanTile - 1) / kScanTile;
    if (top > 0) start[top + 1] = start[top] + len[top];
    ++top;
  }
  const int tiles0 = len[1];
  const bool one_pass = tiles0 <= groups;
  float p0 = 0.0f;
  for (int base = 0; base < tiles0; base += groups) {   // the same passes for every thread
    const int t = base + group, i = t * kScanTile + lane;
    const float v = i < n ? as_float(src[i]) : 0.0f;
    const float acc = tile_prefix(v, lane, tile_last(n, t));
    if (one_pass)
      p0 = acc;
    else if (i < n)
      dest[i] = acc;
    if (lane == kScanTile - 1 && t < tiles0) lvl[t] = acc;
  }
  __syncthreads();
  // a warp's first tile of a pass above level 0 is base + warp_group; a
  // warp with none skips the pass (the test is the same for all its lanes)
  const int warp_group = threadIdx.x / kWarp * (kWarp / kScanTile);
  for (int k = 1; k < top; ++k) {
    const float* level = lvl + start[k];
    for (int base = 0; base < len[k + 1]; base += groups) {
      if (base + warp_group >= len[k + 1]) continue;
      const int t = base + group, i = t * kScanTile + lane;
      const float v = i < len[k] ? level[i] : 0.0f;
      const float acc = tile_prefix(v, lane, tile_last(len[k], t));
      if (i < len[k]) lvl[start[k] + i] = acc;
      if (lane == kScanTile - 1 && t < len[k + 1]) lvl[start[k + 1] + t] = acc;
    }
    __syncthreads();
  }
  if (threadIdx.x < kWarp) {              // the top level, at most 16 values
    const int m = len[top];
    const float v = threadIdx.x < m ? lvl[start[top] + threadIdx.x] : 0.0f;
    const float acc = tile_prefix(v, lane, m - 1);
    if (threadIdx.x < m) lvl[start[top] + threadIdx.x] = acc;
  }
  __syncthreads();
  for (int k = top - 1; k >= 1; --k) {
    for (int i = threadIdx.x; i < len[k]; i += blockDim.x) {
      const int t = i / kScanTile;
      lvl[start[k] + i] =
          __fadd_rn(lvl[start[k] + i], t > 0 ? lvl[start[k + 1] + t - 1] : 0.0f);
    }
    __syncthreads();
  }
  for (int base = 0; base < tiles0; base += groups) {
    const int t = base + group, i = t * kScanTile + lane;
    if (i < n) {
      const float prefix = one_pass ? p0 : dest[i];
      dest[i] = finish<kFinal>(__fadd_rn(prefix, t > 0 ? lvl[t - 1] : 0.0f));
    }
  }
}

// A level of n > kDigestReach values, down: each tile's in-tile prefixes to
// dest (which may be src) and its total to totals.
template <typename T>
__global__ void __launch_bounds__(kDigestThreads)
    digest_tiles_kernel(const T* src, int n, float* dest, float* __restrict__ totals) {
  const int lane = threadIdx.x % kScanTile;
  const long long t =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kScanTile) + threadIdx.x / kScanTile;
  const long long i = t * kScanTile + lane;
  const float v = i < n ? as_float(src[i]) : 0.0f;
  const float acc = tile_prefix(v, lane, tile_last(n, t));
  if (i < n) dest[i] = acc;
  if (lane == kScanTile - 1 && i - lane < n) totals[t] = acc;
}

// A level of n > kDigestReach values, up: each in-tile prefix plus the
// scanned total of the tiles before its tile, in place, under finish.
template <bool kFinal>
__global__ void digest_offsets_kernel(float* dest, int n, const float* __restrict__ scanned) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long t = i / kScanTile;
  dest[i] = finish<kFinal>(__fadd_rn(dest[i], t > 0 ? scanned[t - 1] : 0.0f));
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

// Threads of a digest block for a level of n <= kDigestReach: 16 a tile,
// whole warps.
int digest_block_threads(int n) {
  const int tiles = (n + kScanTile - 1) / kScanTile;
  const int threads = (tiles * kScanTile + kWarp - 1) / kWarp * kWarp;
  return threads < kDigestThreads ? threads : kDigestThreads;
}

// The levels of a digest of B tuples past one block's reach: level k + 1,
// the totals of level k's tiles, at scratch + start[k + 1] (level 0 is the
// input, its prefixes in the output), down to the first level g that one
// block takes whole.  Returns g; the scratch is start[g] + len[g] floats.
int digest_levels(long long B, long long* len, long long* start) {
  int g = 0;
  len[0] = B;
  start[0] = start[1] = 0;
  while (len[g] > kDigestReach) {
    len[g + 1] = (len[g] + kScanTile - 1) / kScanTile;
    if (g > 0) start[g + 1] = start[g] + len[g];
    ++g;
  }
  return g;
}

template <typename T>
cudaError_t launch_digest(const T* x, int B, float* out, float* scratch, long long scratch_floats,
                          cudaStream_t s) {
  if (B <= kDigestReach) {
    digest_block_kernel<T, true><<<1, digest_block_threads(B), 0, s>>>(x, B, out);
    return cudaGetLastError();
  }
  long long len[kMaxLevels], start[kMaxLevels];
  const int g = digest_levels(B, len, start);
  if (scratch == nullptr || scratch_floats < start[g] + len[g]) return cudaErrorInvalidValue;
  auto level = [&](int k) { return k == 0 ? out : scratch + start[k]; };
  auto blocks = [](long long n, int per_block) {
    return static_cast<unsigned>((n + per_block - 1) / per_block);
  };
  const int tiles_per_block = kDigestThreads / kScanTile;
  for (int k = 0; k < g; ++k) {
    const unsigned grid = blocks(len[k + 1], tiles_per_block);
    if (k == 0)
      digest_tiles_kernel<T><<<grid, kDigestThreads, 0, s>>>(x, B, out, level(1));
    else
      digest_tiles_kernel<float><<<grid, kDigestThreads, 0, s>>>(
          level(k), static_cast<int>(len[k]), level(k), level(k + 1));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int top = static_cast<int>(len[g]);
  digest_block_kernel<float, false><<<1, digest_block_threads(top), 0, s>>>(level(g), top,
                                                                            level(g));
  for (int k = g - 1; k >= 0; --k) {
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const unsigned grid = blocks(len[k], kDigestOffsetThreads);
    if (k == 0)
      digest_offsets_kernel<true><<<grid, kDigestOffsetThreads, 0, s>>>(out, B, level(1));
    else
      digest_offsets_kernel<false><<<grid, kDigestOffsetThreads, 0, s>>>(
          level(k), static_cast<int>(len[k]), level(k + 1));
  }
  return cudaGetLastError();
}

}  // namespace

// lanes: the vector path's lanes a row (a power of two, at most 32; the
// payload 16-byte aligned and L % 16 == 0), or 0 for the byte path.  The
// wrapper chooses; a vector launch the payload does not allow is refused.
extern "C" int repro_parse_xml(const void* payload, int B, int L, int lanes, void* tags,
                               void* checksum, int device, void* stream) {
  if (B < 1 || L < 1 || payload == nullptr || tags == nullptr || checksum == nullptr)
    return (int)cudaErrorInvalidValue;
  if (lanes != 0 && (lanes < 0 || lanes > kWarp || (lanes & (lanes - 1)) != 0 ||
                     L % kChunk != 0 || reinterpret_cast<uintptr_t>(payload) % kChunk != 0))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* bytes = static_cast<const uint8_t*>(payload);
  if (lanes != 0) {
    const long long threads = static_cast<long long>(B) * lanes;
    const int block = threads < kParseThreads
                          ? static_cast<int>((threads + kWarp - 1) / kWarp * kWarp)
                          : kParseThreads;
    parse_xml_kernel<true><<<static_cast<unsigned>((threads + block - 1) / block), block, 0, s>>>(
        bytes, B, L, lanes, static_cast<int*>(tags), static_cast<int*>(checksum));
  } else {
    parse_xml_kernel<false><<<(B + kRowsPerBlock - 1) / kRowsPerBlock, kRowsPerBlock * kWarp, 0,
                              s>>>(bytes, B, L, 0, static_cast<int*>(tags),
                                   static_cast<int*>(checksum));
  }
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

// The longest part the digest takes in one block, with no scratch.
extern "C" const int repro_rolling_digest_reach = kDigestReach;

// float32 scratch the digest needs for a part of B: the tile totals of
// each level past one block's reach; 0 within it.
extern "C" long long repro_rolling_digest_scratch_floats(int B) {
  if (B <= kDigestReach) return 0;
  long long len[kMaxLevels], start[kMaxLevels];
  const int g = digest_levels(B, len, start);
  return start[g] + len[g];
}

extern "C" int repro_rolling_digest(const void* x, int is_int, int B, void* out, void* scratch,
                                    long long scratch_floats, int device, void* stream) {
  if (B < 1 || x == nullptr || out == nullptr || (is_int != 0 && is_int != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* scr = static_cast<float*>(scratch);
  return (int)(is_int ? launch_digest(static_cast<const int*>(x), B, o, scr, scratch_floats, s)
                      : launch_digest(static_cast<const float*>(x), B, o, scr, scratch_floats, s));
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
