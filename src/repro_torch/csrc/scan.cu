// Hand-written Hopper kernels for the prefix-sum path of the tuning loop.
//
//   repro_scan_add   replaces repro/kernels/scan/kernel.py scan_add_pallas
//                    (the fused launch, and multipass launches 1 and 2);
//   repro_apply_add  replaces repro/kernels/blocks/driver.py _apply_add
//                    (multipass launch 3).
//
// Built with nvcc for sm_90a into a shared library with a plain C
// interface (loaded with ctypes by repro_torch/kernels/build.py).  Every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or the error of the call that failed first).
//
// scan_add — what it computes.  The inclusive prefix sum of each row of a
// (batch, n) array, in f32 whatever the input type (f32 or bf16), written
// back in the input type.  It follows the plan the tuner chose:
//   * one thread block owns `rows` rows (the CUDA grid is batch / rows);
//   * the TPU kernel's sequential column axis (n / tile_n tiles, carried in
//     VMEM scratch) becomes a loop inside the block, because a CUDA grid
//     has no order; the f32 row carry lives in shared memory;
//   * each tile is staged through shared memory in f32 and runs the plan's
//     stage sequence: stage s folds the fan_in[s] - 1 neighbours at
//     multiples of stride[s] = prod(fan_in[:s]) into every element, with the
//     mixed-radix (ragged) last stage and any large prime fan-in included;
//     every thread reads its neighbours, the block syncs, then writes;
//   * `unroll` is both the fold order of primitives.shift_fold (one add
//     after another for 1, a balanced pairwise tree for > 1) and the
//     least number of tile elements each thread owns (instruction-level
//     parallelism); the thread count follows from it.
// What bounds it on the card: it reads each input byte once and writes
// each output byte once, so the bound is memory bandwidth.  The design
// keeps every intermediate stage and the carry on chip (shared memory and
// registers), computes each element's (row, column) once per launch, loads
// the next column tile into registers while the current one runs its
// stages (up to 8 elements a thread), and alternates two shared-memory
// tiles between stages where both fit (one barrier per stage instead of
// two).  What it does not do yet (TMA / cp.async staging, warp-shuffle
// scans) is later work.
//
// apply_add — multipass launch 3: out = y + entry[row], y and entry f32,
// out f32 or bf16 (so the one-shot output quantization of the multipass
// path needs no extra pass).  One block owns `rows` rows; bound by memory
// bandwidth (one read of y, one write of out).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace {

constexpr int kMaxStages = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxElemsPerThread = 32;
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use
constexpr int kTreeSlots = 16;  // binary-counter slots: fan-in < 2^16

struct Stages {
  int count;
  int fan_in[kMaxStages];
  int stride[kMaxStages];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Neighbour k * stride to the left within the tile row, or the monoid
// identity 0 where the shift runs off the row's start.
__device__ __forceinline__ float neighbour(const float* tile, int idx, int col,
                                           int off) {
  return col >= off ? tile[idx - off] : 0.0f;
}

// One stage for one element: x plus its k = 1 .. fan_in-1 neighbours
// (those with k * stride < tile_n), in the order of primitives.shift_fold.
__device__ float fold_element(const float* tile, int idx, int col, float x,
                              int fan_in, int stride, int tile_n, int unroll) {
  int k_max = fan_in - 1;
  if (stride > 0) {
    const int reach = (tile_n - 1) / stride;
    if (reach < k_max) k_max = reach;
  }
  if (k_max <= 0) return x;
  if (unroll <= 1) {
    float acc = x;
    for (int k = 1; k <= k_max; ++k) acc += neighbour(tile, idx, col, k * stride);
    return acc;
  }
  if (k_max <= 7) {
    // _tree_fold of up to 7 parts, written out so the parts stay in
    // registers: pairs level by level, an odd tail passes through.
    float p[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
      p[k] = k < k_max ? neighbour(tile, idx, col, (k + 1) * stride) : 0.0f;
    float t;
    switch (k_max) {
      case 1: t = p[0]; break;
      case 2: t = p[0] + p[1]; break;
      case 3: t = (p[0] + p[1]) + p[2]; break;
      case 4: t = (p[0] + p[1]) + (p[2] + p[3]); break;
      case 5: t = ((p[0] + p[1]) + (p[2] + p[3])) + p[4]; break;
      case 6: t = ((p[0] + p[1]) + (p[2] + p[3])) + (p[4] + p[5]); break;
      default: t = ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + p[6]);
    }
    return x + t;
  }
  // Large fan-in (a tile with a large prime factor): the same balanced
  // tree, streamed.  slot[L] holds the sum of the latest complete aligned
  // block of 2^L parts; pushing a part merges equal-sized blocks left to
  // right, and the tail folds from the smallest block up, which is exactly
  // the level-by-level pairing of _tree_fold.
  float slot[kTreeSlots];
  unsigned count = 0;
  for (int k = 1; k <= k_max; ++k) {
    float v = neighbour(tile, idx, col, k * stride);
    int level = 0;
    while ((count >> level) & 1u) {
      v = slot[level] + v;
      ++level;
    }
    slot[level] = v;
    ++count;
  }
  float t = 0.0f;
  bool first = true;
  for (int level = 0; level < kTreeSlots; ++level) {
    if ((count >> level) & 1u) {
      t = first ? slot[level] : slot[level] + t;
      first = false;
    }
  }
  return x + t;
}

// Elements per thread up to which the next column tile is prefetched into
// registers while the current one runs its stages (beyond it the extra
// registers would spill).
constexpr int kPrefetchMaxElems = 8;

template <typename T, int E>
__global__ void __launch_bounds__(kMaxThreads)
    scan_add_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                    int rows, int tile_n, Stages stages, int unroll,
                    int ping_pong) {
  constexpr bool kPrefetch = E <= kPrefetchMaxElems;
  extern __shared__ float smem[];
  const int total = rows * tile_n;
  // f32 staging: one tile, or two when stages alternate between them (one
  // barrier per stage instead of two); then the row carry
  float* tile = smem;
  float* other = ping_pong ? smem + total : smem;
  float* carry = smem + (ping_pong ? 2 * total : total);
  const int threads = blockDim.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  for (int r = threadIdx.x; r < rows; r += threads) carry[r] = 0.0f;

  // element e of this thread sits at tile index threadIdx.x + e * threads
  // for every column tile: its (row, column), packed as row << 16 | column
  // (both < 2^15), is computed once; -1 marks a slot past the tile
  int rc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = threadIdx.x + e * threads;
    const int r = idx / tile_n;
    rc[e] = idx < total ? (r << 16) | (idx - r * tile_n) : -1;
  }
  auto offset = [&](int packed, long long col0) {
    return (row0 + (packed >> 16)) * n + col0 + (packed & 0xffff);
  };

  float v[E];
  float next[E];
  const long long seq_tiles = n / tile_n;
  for (long long j = 0; j < seq_tiles; ++j) {
    const long long col0 = j * tile_n;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (rc[e] < 0) continue;
      if (!kPrefetch || j == 0) v[e] = to_f32(x[offset(rc[e], col0)]);
      tile[threadIdx.x + e * threads] = v[e];
    }
    __syncthreads();
    if (kPrefetch && j + 1 < seq_tiles) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (rc[e] >= 0) next[e] = to_f32(x[offset(rc[e], col0 + tile_n)]);
    }
    for (int s = 0; s < stages.count; ++s) {
      const int fan_in = stages.fan_in[s];
      const int stride = stages.stride[s];
      const float* src = (s & 1) ? other : tile;
      float* dst = (s & 1) ? tile : other;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (rc[e] < 0) continue;
        v[e] = fold_element(src, threadIdx.x + e * threads, rc[e] & 0xffff,
                            v[e], fan_in, stride, tile_n, unroll);
      }
      if (s + 1 < stages.count) {  // the last stage's result stays in v
        if (!ping_pong) __syncthreads();  // every read before any write
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (rc[e] >= 0) dst[threadIdx.x + e * threads] = v[e];
        __syncthreads();
      }
    }
    // carry chain: fold the running row prefix in, then hand the tile's
    // last column on to the next tile
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (rc[e] >= 0) v[e] += carry[rc[e] >> 16];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (rc[e] < 0) continue;
      from_f32(&y[offset(rc[e], col0)], v[e]);
      if ((rc[e] & 0xffff) == tile_n - 1) carry[rc[e] >> 16] = v[e];
      if (kPrefetch) v[e] = next[e];
    }
    __syncthreads();
  }
}

template <typename TO>
__global__ void apply_add_kernel(const float* __restrict__ y,
                                 const float* __restrict__ entry,
                                 TO* __restrict__ out, long long length,
                                 int rows) {
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  for (int r = 0; r < rows; ++r) {
    const float e = entry[row0 + r];
    const float* yr = y + (row0 + r) * length;
    TO* orow = out + (row0 + r) * length;
    for (long long c = threadIdx.x; c < length; c += blockDim.x)
      from_f32(&orow[c], yr[c] + e);
  }
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

template <typename T, int E>
cudaError_t launch_scan(const void* x, void* y, long long batch, long long n,
                        int rows, int tile_n, const Stages& stages, int unroll,
                        int threads, cudaStream_t stream) {
  auto kernel = scan_add_kernel<T, E>;
  const size_t tile_bytes = sizeof(float) * static_cast<size_t>(rows) * tile_n;
  const size_t carry_bytes = sizeof(float) * rows;
  const int ping_pong = 2 * tile_bytes + carry_bytes <= kSmemLimit ? 1 : 0;
  const size_t smem = (ping_pong ? 2 : 1) * tile_bytes + carry_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(batch / rows);
  kernel<<<blocks, threads, smem, stream>>>(static_cast<const T*>(x),
                                            static_cast<T*>(y), n, rows,
                                            tile_n, stages, unroll, ping_pong);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scan(int elems, const void* x, void* y, long long batch,
                          long long n, int rows, int tile_n,
                          const Stages& stages, int unroll, int threads,
                          cudaStream_t stream) {
  switch (elems) {
    case 1: return launch_scan<T, 1>(x, y, batch, n, rows, tile_n, stages, unroll, threads, stream);
    case 2: return launch_scan<T, 2>(x, y, batch, n, rows, tile_n, stages, unroll, threads, stream);
    case 4: return launch_scan<T, 4>(x, y, batch, n, rows, tile_n, stages, unroll, threads, stream);
    case 8: return launch_scan<T, 8>(x, y, batch, n, rows, tile_n, stages, unroll, threads, stream);
    case 16: return launch_scan<T, 16>(x, y, batch, n, rows, tile_n, stages, unroll, threads, stream);
    case 32: return launch_scan<T, 32>(x, y, batch, n, rows, tile_n, stages, unroll, threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Elements per thread and threads per block the scan kernel uses for a
// (rows x tile_n) tile at this unroll; written to out[0], out[1].
// Returns 0, or cudaErrorInvalidValue for a tile it does not take.
int scan_geometry(int rows, int tile_n, int unroll, int* out) {
  const int total = rows * tile_n;
  if (rows < 1 || tile_n < 1 || unroll < 1 ||
      total > kMaxThreads * kMaxElemsPerThread)
    return cudaErrorInvalidValue;
  int need = (total + kMaxThreads - 1) / kMaxThreads;
  const int elems = pow2_ceil(need > unroll ? need : unroll);
  if (elems > kMaxElemsPerThread) return cudaErrorInvalidValue;
  int threads = (total + elems - 1) / elems;
  threads = ((threads + 31) / 32) * 32;
  out[0] = elems;
  out[1] = threads;
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x, y: (batch, n) contiguous on the
// device; batch % rows == 0, n % tile_n == 0, prod(stages) == tile_n.
int repro_scan_add(const void* x, void* y, int dtype, long long batch,
                   long long n, int rows, int tile_n, const int* fan_in,
                   int n_stages, int unroll, void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages || batch % rows || n % tile_n)
    return cudaErrorInvalidValue;
  int geometry[2];
  if (scan_geometry(rows, tile_n, unroll, geometry))
    return cudaErrorInvalidValue;
  Stages stages;
  stages.count = n_stages;
  int stride = 1;
  for (int s = 0; s < n_stages; ++s) {
    stages.fan_in[s] = fan_in[s];
    stages.stride[s] = stride;
    stride *= fan_in[s];
  }
  if (stride != tile_n) return cudaErrorInvalidValue;
  if (sizeof(float) * (static_cast<size_t>(rows) * tile_n + rows) > kSmemLimit)
    return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_scan<float>(geometry[0], x, y, batch, n, rows, tile_n,
                                stages, unroll, geometry[1], strm);
  if (dtype == 1)
    return dispatch_scan<__nv_bfloat16>(geometry[0], x, y, batch, n, rows,
                                        tile_n, stages, unroll, geometry[1],
                                        strm);
  return cudaErrorInvalidValue;
}

// out_dtype: 0 = float32, 1 = bfloat16.  y: (n_rows, length) f32, entry:
// (n_rows,) f32, out: (n_rows, length); n_rows % rows == 0.
int repro_apply_add(const float* y, const float* entry, void* out,
                    int out_dtype, long long n_rows, long long length,
                    int rows, void* stream) {
  if (rows < 1 || n_rows % rows) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(n_rows / rows);
  long long want = ((length + 31) / 32) * 32;
  const int threads = static_cast<int>(want < 256 ? want : 256);
  auto strm = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    apply_add_kernel<float><<<blocks, threads, 0, strm>>>(
        y, entry, static_cast<float*>(out), length, rows);
  else if (out_dtype == 1)
    apply_add_kernel<__nv_bfloat16><<<blocks, threads, 0, strm>>>(
        y, entry, static_cast<__nv_bfloat16*>(out), length, rows);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// codes 20000 and up come from sm90.cuh's tensor-map helper
const char* repro_error_string(int code) {
  static thread_local char msg[96];
  if (code == 20000)
    return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  if (code > 20000) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the tensor "
             "map (CUresult %d)", code - 20001);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
