// Hand-written Hopper kernels for the linear recurrence h_t = a_t h_{t-1} + b_t.
//
//   repro_scan_linrec   replaces repro/kernels/scan/kernel.py
//                       scan_linrec_pallas (carry = 1) and
//                       scan_linrec_prod_pallas (carry = 0, products out);
//   repro_apply_linrec  replaces repro/kernels/blocks/driver.py
//                       _apply_linrec (multipass launch 3).
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py).  Every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or the error of the call that failed first).
//
// scan_linrec — what it computes.  Rows of (batch, n) pairs (a, b), in f32
// whatever the input type (f32 or bf16), written back in the input type:
//   * one thread block owns `rows` rows (the CUDA grid is batch / rows);
//   * the TPU kernel's sequential column axis becomes a loop over the
//     n / tile_n column tiles inside the block, with the f32 row carry in
//     shared memory: h = b + a * carry (primitives.carry_fold_linrec), the
//     tile's last h is the next tile's carry;
//   * each tile runs the plan's stage sequence of linrec_level folds: at
//     stage s every element composes its k = 1 .. fan_in[s] - 1 neighbours
//     at k * stride[s], in that order (acc_b = acc_a * sb + acc_b, then
//     acc_a = acc_a * sa), reading the identity (a = 1, b = 0) off the
//     row's start — ragged and prime fan-ins included.  The composition
//     order is the algebra's, so there is no unroll knob;
//   * `gate` applies the RG-LRU input gate b = sqrt(max(1 - a^2, 0)) * u
//     before the first stage (b holds u);
//   * the multipass chunk kernel (carry_on = 0, one tile per row) folds no
//     carry and writes the prefix products of a beside h.
// Every multiply and add is __fmul_rn / __fadd_rn: no FMA contraction, so
// the kernel rounds exactly where its plain version does.
//
// What bounds it on the card: memory bandwidth (one read of a and b, one
// write of h, and of p for the chunk kernel).  The design keeps every
// stage and the carry on chip: each thread holds its elements' (a, b) in
// registers and publishes them to two f32 planes per stage.  The planes
// live in shared memory — two pairs (ping-pong, one barrier per stage)
// where they fit, else one pair (two barriers) — and, for the one tile
// size whose pair exceeds a block's 227 KB (32768 elements, admitted for
// bf16), in a global-memory scratch the wrapper allocates, block by block
// (L2-resident at that size).  Faster staging (TMA, warp-shuffle scans,
// prefetch of the next tile) is later work.
//
// apply_linrec — out = h + p * entry[row], h, p and entry f32, out f32 or
// bf16 (so the multipass path quantizes once, at its output).  One block
// owns `rows` rows; bound by memory bandwidth (two reads, one write).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 32;
constexpr int kMaxThreads = 1024;
constexpr int kMaxElemsPerThread = 32;
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

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

// primitives.rglru_gate: sqrt(max(1 - a * a, 0)) * u, IEEE sqrt; a NaN
// passes through the max, as in torch.clamp_min and jnp.maximum
__device__ __forceinline__ float rglru_gate(float a, float u) {
  const float r = __fsub_rn(1.0f, __fmul_rn(a, a));
  return __fmul_rn(__fsqrt_rn(r < 0.0f ? 0.0f : r), u);
}

template <typename T, int E>
__global__ void __launch_bounds__(kMaxThreads)
    linrec_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ h, T* __restrict__ prod, long long n,
                  int rows, int tile_n, Stages stages, int gate, int carry_on,
                  int ping_pong, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int total = rows * tile_n;
  float* carry = smem;
  // the stage planes: shared memory after the carry, or this block's
  // slice of the global scratch
  float* planes = scratch != nullptr
                      ? scratch + static_cast<size_t>(blockIdx.x) * 2 * total
                      : smem + rows;
  float* plane_a[2] = {planes, ping_pong ? planes + 2 * total : planes};
  float* plane_b[2] = {planes + total,
                       ping_pong ? planes + 3 * total : planes + total};
  const int threads = blockDim.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  for (int r = threadIdx.x; r < rows; r += threads) carry[r] = 0.0f;

  // element e of this thread sits at tile index threadIdx.x + e * threads:
  // its (row, column) packed as row << 16 | column; -1 past the tile
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

  float va[E];
  float vb[E];
  const long long seq_tiles = n / tile_n;
  for (long long j = 0; j < seq_tiles; ++j) {
    const long long col0 = j * tile_n;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (rc[e] < 0) continue;
      const long long o = offset(rc[e], col0);
      va[e] = to_f32(a[o]);
      vb[e] = to_f32(b[o]);
      if (gate) vb[e] = rglru_gate(va[e], vb[e]);
    }
    for (int s = 0; s < stages.count; ++s) {
      float* sa = plane_a[s & 1];
      float* sb = plane_b[s & 1];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (rc[e] < 0) continue;
        sa[threadIdx.x + e * threads] = va[e];
        sb[threadIdx.x + e * threads] = vb[e];
      }
      __syncthreads();
      const int fan_in = stages.fan_in[s];
      const int stride = stages.stride[s];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (rc[e] < 0) continue;
        const int idx = threadIdx.x + e * threads;
        const int col = rc[e] & 0xffff;
        float acc_a = va[e];
        float acc_b = vb[e];
        for (int k = 1; k < fan_in; ++k) {
          const int off = k * stride;
          if (off >= tile_n) break;
          const bool in_row = col >= off;
          const float na = in_row ? sa[idx - off] : 1.0f;  // identity a = 1
          const float nb = in_row ? sb[idx - off] : 0.0f;  // identity b = 0
          acc_b = __fadd_rn(__fmul_rn(acc_a, nb), acc_b);
          acc_a = __fmul_rn(acc_a, na);
        }
        va[e] = acc_a;
        vb[e] = acc_b;
      }
      if (!ping_pong) __syncthreads();  // every read before the next writes
    }
    // va: prefix products of a; vb: the zero-state response, then h
    if (carry_on) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (rc[e] >= 0)
          vb[e] = __fadd_rn(vb[e], __fmul_rn(va[e], carry[rc[e] >> 16]));
    }
    __syncthreads();  // every carry read before the carry is replaced
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if (rc[e] < 0) continue;
      const long long o = offset(rc[e], col0);
      from_f32(&h[o], vb[e]);
      if (prod != nullptr) from_f32(&prod[o], va[e]);
      if ((rc[e] & 0xffff) == tile_n - 1) carry[rc[e] >> 16] = vb[e];
    }
    __syncthreads();
  }
}

template <typename TO>
__global__ void apply_linrec_kernel(const float* __restrict__ h,
                                    const float* __restrict__ p,
                                    const float* __restrict__ entry,
                                    TO* __restrict__ out, long long length,
                                    int rows) {
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  for (int r = 0; r < rows; ++r) {
    const float e = entry[row0 + r];
    const long long base = (row0 + r) * length;
    for (long long c = threadIdx.x; c < length; c += blockDim.x)
      from_f32(&out[base + c], __fadd_rn(h[base + c], __fmul_rn(p[base + c], e)));
  }
}

int pow2_ceil(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// How a (rows x tile_n) tile is laid out: elements per thread, threads, and
// where the stage planes go (0: global scratch, 1: one shared pair,
// 2: two shared pairs).  Returns 0, or cudaErrorInvalidValue.
int linrec_geometry(int rows, int tile_n, int* out) {
  const int total = rows * tile_n;
  if (rows < 1 || tile_n < 1 || tile_n > 65535 ||
      total > kMaxThreads * kMaxElemsPerThread)
    return cudaErrorInvalidValue;
  const int elems = pow2_ceil((total + kMaxThreads - 1) / kMaxThreads);
  int threads = (total + elems - 1) / elems;
  threads = ((threads + 31) / 32) * 32;
  const size_t pair = 2 * sizeof(float) * static_cast<size_t>(total);
  const size_t carry = sizeof(float) * rows;
  out[0] = elems;
  out[1] = threads;
  out[2] = 2 * pair + carry <= kSmemLimit ? 2 : (pair + carry <= kSmemLimit ? 1 : 0);
  return 0;
}

template <typename T, int E>
cudaError_t launch_linrec(const void* a, const void* b, void* h, void* prod,
                          long long batch, long long n, int rows, int tile_n,
                          const Stages& stages, int gate, int carry_on,
                          int threads, int placement, float* scratch,
                          cudaStream_t stream) {
  auto kernel = linrec_kernel<T, E>;
  const size_t total = static_cast<size_t>(rows) * tile_n;
  const size_t smem = sizeof(float) * (rows + (placement == 2   ? 4 * total
                                               : placement == 1 ? 2 * total
                                                                : 0));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(batch / rows);
  kernel<<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<T*>(prod), n, rows, tile_n, stages, gate, carry_on,
      placement == 2 ? 1 : 0, placement == 0 ? scratch : nullptr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_linrec(int elems, const void* a, const void* b, void* h,
                            void* prod, long long batch, long long n, int rows,
                            int tile_n, const Stages& stages, int gate,
                            int carry_on, int threads, int placement,
                            float* scratch, cudaStream_t stream) {
#define REPRO_LINREC_CASE(E)                                                  \
  case E:                                                                     \
    return launch_linrec<T, E>(a, b, h, prod, batch, n, rows, tile_n, stages, \
                               gate, carry_on, threads, placement, scratch,   \
                               stream);
  switch (elems) {
    REPRO_LINREC_CASE(1)
    REPRO_LINREC_CASE(2)
    REPRO_LINREC_CASE(4)
    REPRO_LINREC_CASE(8)
    REPRO_LINREC_CASE(16)
    REPRO_LINREC_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LINREC_CASE
}

}  // namespace

extern "C" {

// Floats of global scratch repro_scan_linrec needs for this tile and batch
// (0 when its stage planes fit in shared memory), or -1 for a tile the
// kernel does not take.
long long repro_linrec_scratch(long long batch, int rows, int tile_n) {
  int geometry[3];
  if (linrec_geometry(rows, tile_n, geometry)) return -1;
  return geometry[2] == 0 ? 2 * batch * static_cast<long long>(tile_n) : 0;
}

// dtype: 0 = float32, 1 = bfloat16.  a, b, h (and prod unless null):
// (batch, n) contiguous on the device; batch % rows == 0, n % tile_n == 0,
// prod(fan_in) == tile_n.  carry_on = 0 folds no row carry (the chunk
// kernel: tile_n == n).  scratch: repro_linrec_scratch(...) floats, or
// null when that is 0.
int repro_scan_linrec(const void* a, const void* b, void* h, void* prod,
                      int dtype, long long batch, long long n, int rows,
                      int tile_n, const int* fan_in, int n_stages, int gate,
                      int carry_on, float* scratch, void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages || rows < 1 || tile_n < 1 ||
      batch % rows || n % tile_n)
    return cudaErrorInvalidValue;
  int geometry[3];
  if (linrec_geometry(rows, tile_n, geometry)) return cudaErrorInvalidValue;
  if (geometry[2] == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  Stages stages;
  stages.count = n_stages;
  int stride = 1;
  for (int s = 0; s < n_stages; ++s) {
    stages.fan_in[s] = fan_in[s];
    stages.stride[s] = stride;
    stride *= fan_in[s];
  }
  if (stride != tile_n) return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_linrec<float>(geometry[0], a, b, h, prod, batch, n, rows,
                                  tile_n, stages, gate, carry_on, geometry[1],
                                  geometry[2], scratch, strm);
  if (dtype == 1)
    return dispatch_linrec<__nv_bfloat16>(geometry[0], a, b, h, prod, batch, n,
                                          rows, tile_n, stages, gate, carry_on,
                                          geometry[1], geometry[2], scratch,
                                          strm);
  return cudaErrorInvalidValue;
}

// out_dtype: 0 = float32, 1 = bfloat16.  h, p: (n_rows, length) f32,
// entry: (n_rows,) f32, out: (n_rows, length); n_rows % rows == 0.
int repro_apply_linrec(const float* h, const float* p, const float* entry,
                       void* out, int out_dtype, long long n_rows,
                       long long length, int rows, void* stream) {
  if (rows < 1 || n_rows % rows) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(n_rows / rows);
  long long want = ((length + 31) / 32) * 32;
  const int threads = static_cast<int>(want < 256 ? want : 256);
  auto strm = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    apply_linrec_kernel<float><<<blocks, threads, 0, strm>>>(
        h, p, entry, static_cast<float*>(out), length, rows);
  else if (out_dtype == 1)
    apply_linrec_kernel<__nv_bfloat16><<<blocks, threads, 0, strm>>>(
        h, p, entry, static_cast<__nv_bfloat16*>(out), length, rows);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
