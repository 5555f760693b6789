// Hand-written Hopper kernels for the prefix-sum path of the tuning loop.
//
//   repro_scan_add_warp  replaces repro/kernels/scan/kernel.py
//                        scan_add_pallas (the fused launch, and multipass
//                        launches 1 and 2) for power-of-two tiles of 128
//                        to 32768 columns with fan-ins 2, 4 and 8: every
//                        config of the h100 scan space (route "warp");
//   repro_scan_add       the same function for any other tile and stage
//                        sequence (ragged and prime fan-ins, tiles that are
//                        not a power of two; route "block");
//   repro_apply_add      replaces repro/kernels/blocks/driver.py _apply_add
//                        (multipass launch 3).
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
//     has no order; the f32 row carry follows the loop;
//   * each tile runs the plan's stage sequence: stage s folds the
//     fan_in[s] - 1 neighbours at multiples of stride[s] = prod(fan_in[:s])
//     into every element (0 where the shift runs off the tile's row), in
//     the order of primitives.shift_fold: one add after another for
//     unroll 1, `x + tree(neighbours)` (the balanced pairwise tree of
//     _tree_fold) for unroll > 1; then v += carry[row].  Both kernels keep
//     that order, so they equal scan_add_plain bit for bit.
//
// What bounds it on the card: it reads each input byte once and writes
// each output byte once, so the bound is memory bandwidth; the stages are
// on-chip work that has to hide under the loads.  The block kernel (route
// "block", scan_add_kernel below) was held back by that work: one block of
// 1024 threads per SM (__launch_bounds__(1024) caps it at 64 registers,
// and its E = 16 / 32 variants spill), a runtime-generic fold (runtime
// fan-in reach, a branch per neighbour, a switch) on every element of
// every stage, every stage through shared memory behind a block barrier,
// and no second block to overlap a tile's loads with another's stages.
//
// The warp kernel (scan_warp_kernel) does this instead:
//   * lane-strided registers: element i of a warp's segment of 32 E
//     columns sits on lane i % 32, register i / 32, loaded and stored
//     coalesced (128 bytes a warp a register, f32), E loads in flight a
//     thread;
//   * the stages with a stride below 32 (the leading ones: 1, 2, 4, 8, 16
//     at radix 2; 1, 4, 16 at radix 4; 1, 8 at radix 8) run in registers:
//     neighbour k * stride is one __shfl_sync (the source lane picks the
//     register its reader needs) or, for whole multiples of 32, another
//     register of the same lane; no shared memory, no barrier;
//   * the fold is specialised at compile time on the fan-in (2, 4, 8), the
//     stride of those shuffle stages and the fold order (a switch per
//     stage, outside the element loop);
//   * a tile of up to 1024 columns is one warp's row (E = tile / 32): the
//     stages with strides of 32 and more go through that warp's own
//     shared-memory row, behind __syncwarp only, and the row carry is a
//     register (broadcast from lane 31), so warps never wait on each
//     other; blocks of at most 8 warps (`rows` rows, walked 8 at a time)
//     leave room for several blocks on an SM;
//   * a longer tile (up to 32768 columns, the multipass chunk and carry
//     scans) spreads a row over tile / 1024 warps of E = 32; each warp
//     also loads the 64 columns before its segment (a halo) and runs the
//     shuffle stages on them, which recomputes exactly what its left
//     neighbour computes, so those stages still need no barrier; the
//     larger strides go through shared memory, conflict-free (lane i reads
//     word i - d), one block barrier a stage (two buffers where they fit);
//     the row carry passes through shared memory.
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

// ---------------------------------------------------------------------------
// The warp kernel (route "warp")
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpMaxTile = 32768;  // columns of a tile (or staged piece)
constexpr int kRowWarpCols = 1024;   // a tile up to this is one warp's row
constexpr int kHalo = 2;             // registers of halo: 64 columns
constexpr int kMaxShflStages = 8;

struct WarpStages {
  int n_shfl;                       // leading stages with stride < 32
  int shfl_f[kMaxShflStages];
  int shfl_s[kMaxShflStages];
  int n_smem;                       // the rest: stride a multiple of 32
  int smem_f[kMaxStages];
  int smem_s[kMaxStages];
};

// x + the F - 1 neighbours p[0 .. F-2], in the order of shift_fold: one
// add after another, or x + _tree_fold(p) (pairs level by level, an odd
// tail passes through).
template <int F, bool TREE>
__device__ __forceinline__ float fold_fixed(float x, const float* p) {
  if constexpr (F == 2) {
    return x + p[0];
  } else if constexpr (!TREE) {
    float acc = x;
#pragma unroll
    for (int k = 0; k < F - 1; ++k) acc = acc + p[k];
    return acc;
  } else if constexpr (F == 4) {
    return x + ((p[0] + p[1]) + p[2]);
  } else {
    static_assert(F == 8, "fan-ins 2, 4 and 8 are specialised");
    return x + (((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + p[6]));
  }
}

// Register i of a[0 .. NA-1] (positions (i - H) * 32 + lane of the
// segment), or 0 left of the array: the fill of a row's start (H = 0), or
// a halo position whose own value is not needed (H > 0).
template <int NA>
__device__ __forceinline__ float reg_or_zero(const float (&a)[NA], int i) {
  return i >= 0 ? a[i] : 0.0f;
}

// One stage of stride S < 32 over the registers, in place from the last
// register down (a register's new value reads only registers at or below
// it).  Neighbour d = k S of position i * 32 + lane is register i - q on
// lane lane - r (d = 32 q + r), or register i - q - 1 on lane lane - r + 32
// when lane < r; the source lane sends whichever its reader needs.
template <int F, int S, bool TREE, int NA>
__device__ __forceinline__ void shfl_stage(float (&a)[NA], int lane) {
#pragma unroll
  for (int i = NA - 1; i >= 0; --i) {
    float p[F - 1];
#pragma unroll
    for (int k = 1; k < F; ++k) {
      const int d = k * S;
      const int q = d >> 5;
      const int r = d & 31;
      const float hi = reg_or_zero(a, i - q);
      if (r == 0) {
        p[k - 1] = hi;
      } else {
        const float lo = reg_or_zero(a, i - q - 1);
        const float send = lane < 32 - r ? hi : lo;
        p[k - 1] = __shfl_sync(kFullMask, send, (lane - r) & 31);
      }
    }
    a[i] = fold_fixed<F, TREE>(a[i], p);
  }
}

// The (fan-in, stride) pairs of the shuffle stages that power-of-two
// tiles at radix 2, 4 and 8 produce (stage_radices), ragged stages
// included; the wrapper's route function admits exactly these.
template <bool TREE, int NA>
__device__ __forceinline__ void shfl_dispatch(float (&a)[NA], int f, int s,
                                              int lane) {
  switch (f * 32 + s) {
#define REPRO_SHFL_CASE(F, S) \
  case F * 32 + S: shfl_stage<F, S, TREE, NA>(a, lane); break;
    REPRO_SHFL_CASE(2, 1)
    REPRO_SHFL_CASE(2, 2)
    REPRO_SHFL_CASE(2, 4)
    REPRO_SHFL_CASE(2, 8)
    REPRO_SHFL_CASE(2, 16)
    REPRO_SHFL_CASE(4, 1)
    REPRO_SHFL_CASE(4, 4)
    REPRO_SHFL_CASE(4, 8)
    REPRO_SHFL_CASE(4, 16)
    REPRO_SHFL_CASE(8, 1)
    REPRO_SHFL_CASE(8, 8)
#undef REPRO_SHFL_CASE
    default: break;
  }
}

// One stage of stride s (a multiple of 32) over E registers, reading the
// stage's input from shared memory: w[base + 32 i] holds register i of
// this thread, col + 32 i is its column in the tile's row.
template <int F, bool TREE, int E>
__device__ __forceinline__ void smem_stage(float* a, const float* w, int base,
                                           int col, int s) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float p[F - 1];
#pragma unroll
    for (int k = 1; k < F; ++k) {
      const int d = k * s;
      p[k - 1] = col + 32 * i >= d ? w[base + 32 * i - d] : 0.0f;
    }
    a[i] = fold_fixed<F, TREE>(a[i], p);
  }
}

template <int E>
__device__ __forceinline__ void smem_dispatch(float* a, const float* w,
                                              int base, int col, int f, int s,
                                              bool tree) {
  if (f == 2) {
    smem_stage<2, false, E>(a, w, base, col, s);
  } else if (f == 4) {
    if (tree) smem_stage<4, true, E>(a, w, base, col, s);
    else smem_stage<4, false, E>(a, w, base, col, s);
  } else {
    if (tree) smem_stage<8, true, E>(a, w, base, col, s);
    else smem_stage<8, false, E>(a, w, base, col, s);
  }
}

// H = 0: a tile of 32 E <= 1024 columns, one warp a row, `group` rows (one
// a warp) at a time.  H = kHalo: a tile of more than 1024 columns, E = 32,
// tile / 1024 warps a row, `group` rows at a time; ping_pong picks two
// shared-memory buffers (one barrier a stage) over one (two).  MAXT bounds
// the block, and with the blocks an SM should hold, the registers a
// thread may take: 128 where E = 32 (at most 1024 threads), else 64.
template <typename T, int E, int H, int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT >= 512 ? 1 : E >= 32 ? 2 : 4)
    scan_warp_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                     int rows, int tile_n, int group, WarpStages st, int tree,
                     int ping_pong) {
  constexpr int NA = H + E;
  constexpr int kSeg = 32 * E;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg_per_row = tile_n / kSeg;  // 1 when H == 0
  const int row_in_group = warp / seg_per_row;
  const int seg_col = (warp - row_in_group * seg_per_row) * kSeg;
  const bool last_seg = seg_col + kSeg == tile_n;
  const int te = blockDim.x * E;           // elements of a row group
  // H == 0: each warp's own row in shared memory; H > 0: the group's rows
  float* buf0 = H ? smem : smem + warp * kSeg;
  float* buf1 = H && ping_pong ? smem + te : buf0;
  float* carry_s = smem + (H && ping_pong ? 2 * te : te);  // [2][group]
  const int base = (H ? warp * kSeg : 0) + lane;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const long long seq_tiles = n / tile_n;
  int stage_no = 0;  // smem stages run so far: picks the ping-pong buffer

  for (int g0 = 0; g0 < rows; g0 += group) {
    const long long row = row0 + g0 + row_in_group;
    const T* xr = x + row * n;
    T* yr = y + row * n;
    float carry = 0.0f;
    if (H) {
      __syncthreads();  // the last group's carry reads are done
      if (threadIdx.x < group) carry_s[threadIdx.x] = 0.0f;
    }
    for (long long j = 0; j < seq_tiles; ++j) {
      const long long col0 = j * tile_n + seg_col;
      float a[NA];
#pragma unroll
      for (int h = 0; h < H; ++h)
        a[h] = seg_col > 0 ? to_f32(xr[col0 - 32 * (H - h) + lane]) : 0.0f;
#pragma unroll
      for (int i = 0; i < E; ++i) a[H + i] = to_f32(xr[col0 + 32 * i + lane]);

      for (int t = 0; t < st.n_shfl; ++t) {
        if (tree) shfl_dispatch<true, NA>(a, st.shfl_f[t], st.shfl_s[t], lane);
        else shfl_dispatch<false, NA>(a, st.shfl_f[t], st.shfl_s[t], lane);
      }
      for (int t = 0; t < st.n_smem; ++t, ++stage_no) {
        float* w = (stage_no & 1) ? buf1 : buf0;
        if (H) {
          if (!ping_pong) __syncthreads();  // every read before any write
        } else {
          __syncwarp();
        }
#pragma unroll
        for (int i = 0; i < E; ++i) w[base + 32 * i] = a[H + i];
        if (H) __syncthreads();
        else __syncwarp();
        smem_dispatch<E>(a + H, w, base, seg_col + lane, st.smem_f[t],
                         st.smem_s[t], tree != 0);
      }
      // carry chain: fold the running row prefix in, hand the tile's last
      // column on (H > 0: through shared memory, ordered by the next
      // tile's stage barriers)
      const float c = H ? carry_s[(j & 1) * group + row_in_group] : carry;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        a[H + i] = a[H + i] + c;
        from_f32(&yr[col0 + 32 * i + lane], a[H + i]);
      }
      if (H) {
        if (last_seg && lane == 31)
          carry_s[((j + 1) & 1) * group + row_in_group] = a[H + E - 1];
      } else {
        carry = __shfl_sync(kFullMask, a[H + E - 1], 31);
      }
    }
  }
}

bool is_pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

// Largest divisor of rows that is at most cap.
int divisor_at_most(int rows, int cap) {
  for (int d = cap < rows ? cap : rows; d > 1; --d)
    if (rows % d == 0) return d;
  return 1;
}

// The warp kernel's plan for a tile: its stages split into shuffle and
// shared-memory ones, threads, rows at a time and shared memory; false
// where the kernel does not take the tile (the wrapper's route function
// never sends such a tile here).
struct WarpGeometry {
  WarpStages st;
  int elems, halo, threads, group, ping_pong;
  size_t smem;
};

bool warp_geometry(int rows, int tile_n, const int* fan_in, int n_stages,
                   WarpGeometry* g) {
  if (rows < 1 || !is_pow2(tile_n) || tile_n < 128 || tile_n > kWarpMaxTile ||
      static_cast<long long>(rows) * tile_n > kWarpMaxTile ||
      n_stages < 1 || n_stages > kMaxStages)
    return false;
  WarpStages& st = g->st;
  st.n_shfl = st.n_smem = 0;
  int stride = 1, reach = 0;
  for (int t = 0; t < n_stages; ++t) {
    const int f = fan_in[t];
    if (f != 2 && f != 4 && f != 8) return false;
    if (stride < 32) {
      const bool ok = f == 2 || (f == 4 && (stride == 1 || stride == 4 ||
                                            stride == 8 || stride == 16)) ||
                      (f == 8 && (stride == 1 || stride == 8));
      if (!ok || st.n_shfl == kMaxShflStages || st.n_smem > 0) return false;
      st.shfl_f[st.n_shfl] = f;
      st.shfl_s[st.n_shfl] = stride;
      ++st.n_shfl;
      reach += (f - 1) * stride;
    } else {
      st.smem_f[st.n_smem] = f;
      st.smem_s[st.n_smem] = stride;
      ++st.n_smem;
    }
    stride *= f;
  }
  if (stride != tile_n) return false;
  if (tile_n <= kRowWarpCols) {
    g->elems = tile_n / 32;
    g->halo = 0;
    g->group = divisor_at_most(rows, 8);
    g->threads = 32 * g->group;
    g->ping_pong = 0;
    g->smem = sizeof(float) * static_cast<size_t>(g->group) * tile_n;
  } else {
    if (reach > 32 * kHalo - 1) return false;
    const int spr = tile_n / kRowWarpCols;
    g->elems = 32;
    g->halo = kHalo;
    g->group = divisor_at_most(rows, spr >= 8 ? 1 : 8 / spr);
    g->threads = 32 * g->group * spr;
    const size_t te = static_cast<size_t>(g->group) * tile_n;
    const size_t carry = sizeof(float) * 2 * g->group;
    g->ping_pong = 2 * sizeof(float) * te + carry <= kSmemLimit ? 1 : 0;
    g->smem = (g->ping_pong ? 2 : 1) * sizeof(float) * te + carry;
  }
  return g->smem <= kSmemLimit;
}

template <typename T, int E, int H, int MAXT>
cudaError_t launch_warp(const void* x, void* y, long long batch, long long n,
                        int rows, int tile_n, const WarpGeometry& g,
                        int unroll, cudaStream_t stream) {
  if (g.threads > MAXT) return cudaErrorInvalidValue;
  auto kernel = scan_warp_kernel<T, E, H, MAXT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  const long long blocks = batch / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(blocks), g.threads, g.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, rows, tile_n, g.group,
      g.st, unroll > 1 ? 1 : 0, g.ping_pong);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_warp(const void* x, void* y, long long batch,
                          long long n, int rows, int tile_n,
                          const WarpGeometry& g, int unroll,
                          cudaStream_t stream) {
  if (g.halo && g.threads > 512)
    return launch_warp<T, 32, kHalo, 1024>(x, y, batch, n, rows, tile_n, g,
                                           unroll, stream);
  if (g.halo)
    return launch_warp<T, 32, kHalo, 512>(x, y, batch, n, rows, tile_n, g,
                                          unroll, stream);
  switch (g.elems) {
    case 4: return launch_warp<T, 4, 0, 256>(x, y, batch, n, rows, tile_n, g, unroll, stream);
    case 8: return launch_warp<T, 8, 0, 256>(x, y, batch, n, rows, tile_n, g, unroll, stream);
    case 16: return launch_warp<T, 16, 0, 256>(x, y, batch, n, rows, tile_n, g, unroll, stream);
    case 32: return launch_warp<T, 32, 0, 256>(x, y, batch, n, rows, tile_n, g, unroll, stream);
    default: return cudaErrorInvalidValue;
  }
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

// The warp kernel (route "warp"): same arguments and contract as
// repro_scan_add; returns cudaErrorInvalidValue for a tile it does not
// take (not a power of two from 128 to 32768 columns, rows * tile_n above
// 32768, a fan-in other than 2, 4 and 8).
int repro_scan_add_warp(const void* x, void* y, int dtype, long long batch,
                        long long n, int rows, int tile_n, const int* fan_in,
                        int n_stages, int unroll, void* stream) {
  if (rows < 1 || tile_n < 1 || unroll < 1 || batch % rows || n % tile_n)
    return cudaErrorInvalidValue;
  WarpGeometry g;
  if (!warp_geometry(rows, tile_n, fan_in, n_stages, &g))
    return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_warp<float>(x, y, batch, n, rows, tile_n, g, unroll,
                                strm);
  if (dtype == 1)
    return dispatch_warp<__nv_bfloat16>(x, y, batch, n, rows, tile_n, g,
                                        unroll, strm);
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
