// Hand-written Hopper kernels for the linear recurrence h_t = a_t h_{t-1} + b_t.
//
//   repro_scan_linrec_warp  replaces repro/kernels/scan/kernel.py
//                           scan_linrec_pallas (carry_on = 1) and
//                           scan_linrec_prod_pallas (carry_on = 0, products
//                           out) for power-of-two tiles of 2 to 32768
//                           columns with fan-ins 2, 4 and 8: every linrec
//                           launch of the h100 scan space at the paper's
//                           sizes and SSD phase B's short rows (route
//                           "warp");
//   repro_scan_linrec       the same function for any other tile and stage
//                           sequence (ragged and prime fan-ins, short tiles;
//                           route "block");
//   repro_apply_linrec      replaces repro/kernels/blocks/driver.py
//                           _apply_linrec (multipass launch 3).
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
//     n / tile_n column tiles inside the block, with the f32 row carry:
//     h = b + a * carry (primitives.carry_fold_linrec), the tile's last h
//     is the next tile's carry;
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
// both kernels round exactly where the plain version does.
//
// What bounds it on the card: memory bandwidth (one read of a and b, one
// write of h, and of p for the chunk kernel); the stages are on-chip work
// that has to hide under the loads.  The block kernel (linrec_kernel, route
// "block") was held back by that work: each thread holds its elements'
// (a, b) and publishes them to two f32 planes per stage, behind a block
// barrier, in blocks of up to 1024 threads whose ping-pong planes (131 KB
// at a 1024 x 8 tile) leave room for one block an SM, with a fold loop
// whose fan-in is known only at run time.
//
// The warp kernel (linrec_warp_kernel) is the warp scan kernel of scan.cu
// with two planes (a, b) in place of one:
//   * lane-strided registers: element i of a warp's segment of 32 E
//     columns sits on lane i % 32, register i / 32, loaded and stored
//     coalesced;
//   * the stages with a stride below 32 run in registers: neighbour
//     k * stride is one __shfl_sync a plane (the source lane picks the
//     register its reader needs) or, for whole multiples of 32, another
//     register of the same lane; the fold is specialised at compile time
//     on (fan-in, stride);
//   * a tile of up to 1024 columns is one warp's row (E = tile / 32): the
//     stages with strides of 32 and more are same-lane registers too
//     (specialised on fan-in and stride / 32), so such a row needs no
//     shared memory and no barrier at all; the row carry is a register
//     (broadcast from lane 31); blocks of at most 8 warps (`rows` rows,
//     walked 8 at a time) leave room for several blocks on an SM;
//   * a tile of at most 32 columns (SSD phase B's rows of chunk states)
//     puts 32 / tile rows in a warp, one element a lane; a neighbour
//     before the lane's row start reads the identity;
//   * a longer tile (up to 32768 columns, the multipass chunk and carry
//     scans) spreads a row over tile / 1024 warps of E = 32; each warp
//     also loads the 64 columns before its segment (a halo) and runs the
//     shuffle stages on them, which recomputes exactly what its left
//     neighbour computes (the pair monoid also reaches only backwards, at
//     most 63 columns over those stages), so those stages need no barrier;
//     the larger strides go through the block's two f32 planes, one block
//     barrier a stage (two pairs where they fit), except that a neighbour
//     inside the warp's own segment is a register of the same lane
//     (strides of 32 to 512, specialised on fan-in and stride / 32), so
//     only the registers a later segment reads are published; the 32768-column tile's
//     pair (256 KB) exceeds a block's 227 KB, so its planes go to a global
//     scratch the wrapper allocates (L2-resident at that size); the row
//     carry passes through shared memory.
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

// ---------------------------------------------------------------------------
// The warp kernel (route "warp")
// ---------------------------------------------------------------------------

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpMinTile = 2;      // columns of a tile (or staged piece)
constexpr int kWarpMaxTile = 32768;
constexpr int kRowWarpCols = 1024;   // a tile up to this is one warp's row
constexpr int kHalo = 2;             // registers of halo: 64 columns
constexpr int kMaxShflStages = 8;
constexpr int kNoRowStart = 1 << 30;  // no row starts inside a warp

struct WarpStages {
  int n_shfl;                       // leading stages with stride < 32
  int shfl_f[kMaxShflStages];
  int shfl_s[kMaxShflStages];
  int n_big;                        // the rest: stride a multiple of 32
  int big_f[kMaxStages];
  int big_s[kMaxStages];
};

// Compose the element's accumulator with one neighbour (na, nb), in
// linrec_level's order: acc_b = acc_a * nb + acc_b, then acc_a *= na.
__device__ __forceinline__ void compose(float& acc_a, float& acc_b, float na,
                                        float nb) {
  acc_b = __fadd_rn(__fmul_rn(acc_a, nb), acc_b);
  acc_a = __fmul_rn(acc_a, na);
}

// Register i of v[0 .. NA-1], or `fill` left of the array: the identity at
// a row's start (H = 0), or a halo position whose own value is not needed
// (H > 0).
template <int NA>
__device__ __forceinline__ float reg_or(const float (&v)[NA], int i,
                                        float fill) {
  return i >= 0 ? v[i] : fill;
}

// One stage of stride S < 32 over the registers, in place from the last
// register down (a register's new value reads only registers at or below
// it).  Neighbour d = k S of position i * 32 + lane is register i - q on
// lane lane - r (d = 32 q + r), or register i - q - 1 on lane lane - r + 32
// when lane < r; the source lane sends whichever its reader needs.  Where
// a warp holds several rows of at most 32 columns, sub_col is the lane's
// column in its row, and a neighbour before the row's start reads the
// identity (else sub_col = kNoRowStart, and the test never holds).
template <int F, int S, int NA>
__device__ __forceinline__ void linrec_shfl_stage(float (&va)[NA],
                                                  float (&vb)[NA], int lane,
                                                  int sub_col) {
#pragma unroll
  for (int i = NA - 1; i >= 0; --i) {
    float acc_a = va[i];
    float acc_b = vb[i];
#pragma unroll
    for (int k = 1; k < F; ++k) {
      const int d = k * S;
      const int q = d >> 5;
      const int r = d & 31;
      const float hi_a = reg_or(va, i - q, 1.0f);
      const float hi_b = reg_or(vb, i - q, 0.0f);
      float na, nb;
      if (r == 0) {
        na = hi_a;
        nb = hi_b;
      } else {
        const bool hi = lane < 32 - r;
        const int src = (lane - r) & 31;
        na = __shfl_sync(kFullMask, hi ? hi_a : reg_or(va, i - q - 1, 1.0f),
                         src);
        nb = __shfl_sync(kFullMask, hi ? hi_b : reg_or(vb, i - q - 1, 0.0f),
                         src);
        if (sub_col < d) {  // a row of fewer than 32 columns starts here
          na = 1.0f;
          nb = 0.0f;
        }
      }
      compose(acc_a, acc_b, na, nb);
    }
    va[i] = acc_a;
    vb[i] = acc_b;
  }
}

// The (fan-in, stride) pairs of the shuffle stages that power-of-two tiles
// at radix 2, 4 and 8 produce (stage_radices), ragged stages included; the
// wrapper's route function (scan_route) admits exactly these.
template <int NA>
__device__ __forceinline__ void linrec_shfl_dispatch(float (&va)[NA],
                                                     float (&vb)[NA], int f,
                                                     int s, int lane,
                                                     int sub_col) {
  switch (f * 32 + s) {
#define REPRO_SHFL_CASE(F, S) \
  case F * 32 + S: linrec_shfl_stage<F, S, NA>(va, vb, lane, sub_col); break;
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

// A row of one warp (H = 0): one stage of stride 32 Q, neighbour k of
// register i being register i - k Q of the same lane (the identity left of
// the row); in place from the last register down.
template <int F, int Q, int E>
__device__ __forceinline__ void linrec_reg_stage(float (&va)[E],
                                                 float (&vb)[E]) {
  if constexpr (F * Q <= E) {   // a stage's reach stays inside the tile
#pragma unroll
    for (int i = E - 1; i >= 0; --i) {
      float acc_a = va[i];
      float acc_b = vb[i];
#pragma unroll
      for (int k = 1; k < F; ++k)
        compose(acc_a, acc_b, reg_or(va, i - k * Q, 1.0f),
                reg_or(vb, i - k * Q, 0.0f));
      va[i] = acc_a;
      vb[i] = acc_b;
    }
  }
}

template <int E>
__device__ __forceinline__ void linrec_reg_dispatch(float (&va)[E],
                                                    float (&vb)[E], int f,
                                                    int q) {
  switch (f * 32 + q) {
#define REPRO_REG_CASE(F, Q) \
  case F * 32 + Q: linrec_reg_stage<F, Q, E>(va, vb); break;
    REPRO_REG_CASE(2, 1)
    REPRO_REG_CASE(2, 2)
    REPRO_REG_CASE(2, 4)
    REPRO_REG_CASE(2, 8)
    REPRO_REG_CASE(2, 16)
    REPRO_REG_CASE(4, 1)
    REPRO_REG_CASE(4, 2)
    REPRO_REG_CASE(4, 4)
    REPRO_REG_CASE(4, 8)
    REPRO_REG_CASE(8, 1)
    REPRO_REG_CASE(8, 2)
    REPRO_REG_CASE(8, 4)
#undef REPRO_REG_CASE
    default: break;
  }
}

// A row over several warps (H > 0): one stage of stride s (a multiple of
// 32) over the E registers of the segment, reading the stage's input from
// the block's planes: wa / wb[base + 32 i] hold register i of this thread,
// col + 32 i is its column in the tile's row.
template <int F, int E>
__device__ __forceinline__ void linrec_smem_stage(float* va, float* vb,
                                                  const float* wa,
                                                  const float* wb, int base,
                                                  int col, int s) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float acc_a = va[i];
    float acc_b = vb[i];
#pragma unroll
    for (int k = 1; k < F; ++k) {
      const int d = k * s;
      const bool in_row = col + 32 * i >= d;
      compose(acc_a, acc_b, in_row ? wa[base + 32 * i - d] : 1.0f,
              in_row ? wb[base + 32 * i - d] : 0.0f);
    }
    va[i] = acc_a;
    vb[i] = acc_b;
  }
}

// A row over several warps (H > 0), a stage of stride 32 Q below the
// segment's 32 E columns: neighbour k of register i is register i - k Q of
// the same lane where that lies in the segment (no data movement), else
// the plane's copy from an earlier segment.  Only the registers a later
// segment reads are published (the top (F - 1) Q, or all), and the
// registers are updated in place from the last down.  sync_first: a
// barrier before the publish (one plane pair: the last stage's reads).
template <int F, int Q, int E>
__device__ __forceinline__ void linrec_seg_stage(float* va, float* vb,
                                                 float* wa, float* wb,
                                                 int base, int col,
                                                 bool sync_first) {
  constexpr int kPub = (F - 1) * Q < E ? (F - 1) * Q : E;
  if (sync_first) __syncthreads();
#pragma unroll
  for (int i = E - kPub; i < E; ++i) {
    wa[base + 32 * i] = va[i];
    wb[base + 32 * i] = vb[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = E - 1; i >= 0; --i) {
    float acc_a = va[i];
    float acc_b = vb[i];
#pragma unroll
    for (int k = 1; k < F; ++k) {
      const int j = i - k * Q;
      if (j >= 0) {
        compose(acc_a, acc_b, va[j], vb[j]);
      } else {
        const int d = 32 * k * Q;
        const bool in_row = col + 32 * i >= d;
        compose(acc_a, acc_b, in_row ? wa[base + 32 * i - d] : 1.0f,
                in_row ? wb[base + 32 * i - d] : 0.0f);
      }
    }
    va[i] = acc_a;
    vb[i] = acc_b;
  }
}

// A plane stage of a row over several warps: (fan-in, stride) specialised
// for the strides inside a segment (in-thread neighbours) that the
// admitted h100 plans reach, the generic stage (all registers published,
// every neighbour read from the planes) for the others, beyond a segment,
// and for the 1024-thread blocks of the 32768-column tile (SPECIALISE
// false: the carry scan's longest piece, where build time counts more).
template <int E, bool SPECIALISE>
__device__ __forceinline__ void linrec_plane_dispatch(float* va, float* vb,
                                                      float* wa, float* wb,
                                                      int base, int col,
                                                      int f, int s,
                                                      bool sync_first) {
  switch (SPECIALISE ? f * 32 + s / 32 : 0) {
#define REPRO_SEG_CASE(F, Q)                                            \
  case F * 32 + Q:                                                      \
    linrec_seg_stage<F, Q, E>(va, vb, wa, wb, base, col, sync_first);   \
    return;
    REPRO_SEG_CASE(2, 1)
    REPRO_SEG_CASE(2, 2)
    REPRO_SEG_CASE(2, 4)
    REPRO_SEG_CASE(2, 8)
    REPRO_SEG_CASE(2, 16)
    REPRO_SEG_CASE(4, 2)
    REPRO_SEG_CASE(4, 8)
    REPRO_SEG_CASE(4, 16)
    REPRO_SEG_CASE(8, 2)
    REPRO_SEG_CASE(8, 16)
#undef REPRO_SEG_CASE
    default: break;
  }
  if (sync_first) __syncthreads();
#pragma unroll
  for (int i = 0; i < E; ++i) {
    wa[base + 32 * i] = va[i];
    wb[base + 32 * i] = vb[i];
  }
  __syncthreads();
  if (f == 2) linrec_smem_stage<2, E>(va, vb, wa, wb, base, col, s);
  else if (f == 4) linrec_smem_stage<4, E>(va, vb, wa, wb, base, col, s);
  else linrec_smem_stage<8, E>(va, vb, wa, wb, base, col, s);
}

// H = 0: a tile of 32 E <= 1024 columns, one warp a row, `group` rows (one
// a warp) at a time; SUB (E = 1): a tile of at most 32 columns, 32 / tile_n
// rows a warp, `group` rows at a time (lanes past them idle).  H = kHalo: a
// tile of more than 1024 columns, E = 32, tile / 1024 warps a row, `group`
// rows at a time; ping_pong picks two plane pairs (one barrier a stage)
// over one (two), `scratch` (when not null) holds them in global memory.
// PROD: the chunk kernel (no carry, the prefix products written to
// `prod`).  MAXT bounds the block and, with the blocks an SM should hold,
// the registers a thread may take: 128 where E >= 16 (at most 512
// threads), else 64.
template <typename T, int E, int H, int MAXT, bool PROD, bool SUB>
__global__ void __launch_bounds__(MAXT, MAXT >= 512 ? 1 : E >= 16 ? 2 : 4)
    linrec_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                       T* __restrict__ h, T* __restrict__ prod, long long n,
                       int rows, int tile_n, int group, WarpStages st,
                       int gate, int ping_pong, float* __restrict__ scratch) {
  static_assert(!SUB || (E == 1 && H == 0), "sub-warp rows are E = 1");
  constexpr int NA = H + E;
  constexpr int kSeg = 32 * E;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this lane's row in the group and the column of its register 0 in the
  // tile's row
  int row_in_group, col_lane, seg_col = 0;
  if constexpr (SUB) {
    row_in_group = warp * (32 / tile_n) + lane / tile_n;
    col_lane = lane & (tile_n - 1);
  } else {
    const int seg_per_row = tile_n / kSeg;  // 1 when H == 0
    row_in_group = warp / seg_per_row;
    seg_col = (warp - row_in_group * seg_per_row) * kSeg;
    col_lane = lane;
  }
  const bool active = row_in_group < group;
  const bool last_seg = seg_col + kSeg >= tile_n;
  const int te = blockDim.x * E;           // H > 0: elements of a row group
  // H > 0: the group's (a, b) planes, in shared memory or this block's
  // slice of the global scratch; the row carry [2][group] in shared memory
  const int pairs = ping_pong ? 2 : 1;
  float* planes = scratch != nullptr
                      ? scratch + static_cast<size_t>(blockIdx.x) * 2 * pairs * te
                      : smem;
  float* wa0 = planes;
  float* wb0 = planes + te;
  float* wa1 = ping_pong ? planes + 2 * te : wa0;
  float* wb1 = ping_pong ? planes + 3 * te : wb0;
  float* carry_s = scratch != nullptr ? smem : smem + 2 * pairs * te;
  const int base = warp * kSeg + lane;
  // the lane holding its row's last column (H == 0)
  const int last_lane = SUB ? (lane | (tile_n - 1)) : 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const long long seq_tiles = n / tile_n;
  int stage_no = 0;  // plane stages run so far: picks the ping-pong pair

  for (int g0 = 0; g0 < rows; g0 += group) {
    const long long row = row0 + g0 + (active ? row_in_group : 0);
    const T* ar = a + row * n;
    const T* br = b + row * n;
    T* hr = h + row * n;
    float carry = 0.0f;
    if (H && !PROD) {
      __syncthreads();  // the last group's carry reads are done
      if (threadIdx.x < group) carry_s[threadIdx.x] = 0.0f;
    }
    for (long long j = 0; j < seq_tiles; ++j) {
      const long long col0 = j * tile_n + seg_col + col_lane;
      float va[NA], vb[NA];
#pragma unroll
      for (int hh = 0; hh < H; ++hh) {
        va[hh] = 1.0f;  // the identity before the tile's start
        vb[hh] = 0.0f;
        if (seg_col > 0) {
          const long long o = col0 - 32 * (H - hh);
          va[hh] = to_f32(ar[o]);
          vb[hh] = to_f32(br[o]);
          if (gate) vb[hh] = rglru_gate(va[hh], vb[hh]);
        }
      }
#pragma unroll
      for (int i = 0; i < E; ++i) {
        va[H + i] = 1.0f;
        vb[H + i] = 0.0f;
        if (active) {
          va[H + i] = to_f32(ar[col0 + 32 * i]);
          vb[H + i] = to_f32(br[col0 + 32 * i]);
          if (gate) vb[H + i] = rglru_gate(va[H + i], vb[H + i]);
        }
      }

      for (int t = 0; t < st.n_shfl; ++t)
        linrec_shfl_dispatch<NA>(va, vb, st.shfl_f[t], st.shfl_s[t], lane,
                                 SUB ? col_lane : kNoRowStart);
      if constexpr (H == 0) {
        for (int t = 0; t < st.n_big; ++t)
          linrec_reg_dispatch<E>(va, vb, st.big_f[t], st.big_s[t] >> 5);
      } else {
        for (int t = 0; t < st.n_big; ++t, ++stage_no) {
          // one plane pair: a barrier first, every read before any write
          linrec_plane_dispatch<E, (MAXT < 1024)>(va + H, vb + H,
                                   (stage_no & 1) ? wa1 : wa0,
                                   (stage_no & 1) ? wb1 : wb0, base,
                                   seg_col + lane, st.big_f[t], st.big_s[t],
                                   !ping_pong);
        }
      }
      // va: prefix products of a; vb: the zero-state response
      if constexpr (PROD) {
        T* pr = prod + row * n;
        if (active) {
#pragma unroll
          for (int i = 0; i < E; ++i) {
            from_f32(&hr[col0 + 32 * i], vb[H + i]);
            from_f32(&pr[col0 + 32 * i], va[H + i]);
          }
        }
      } else {
        // carry chain: h = b + a * carry, the tile's last h handed on (H >
        // 0: through shared memory, ordered by the next tile's barriers)
        const float c = H ? carry_s[(j & 1) * group + row_in_group] : carry;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          vb[H + i] = __fadd_rn(vb[H + i], __fmul_rn(va[H + i], c));
          if (active) from_f32(&hr[col0 + 32 * i], vb[H + i]);
        }
        if (H) {
          if (last_seg && lane == 31)
            carry_s[((j + 1) & 1) * group + row_in_group] = vb[H + E - 1];
        } else {
          carry = __shfl_sync(kFullMask, vb[H + E - 1], last_lane);
        }
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
// larger ones, threads, rows at a time, where the planes go and the shared
// memory; false where the kernel does not take the tile (the wrapper's
// route function never sends such a tile here).
struct WarpGeometry {
  WarpStages st;
  int elems, halo, sub, threads, group, ping_pong, scratch;
  size_t smem;
};

// The geometry of a (rows x tile_n) tile: elements a thread, halo,
// threads, rows at a time, where the planes go, shared memory.
void warp_layout(int rows, int tile_n, WarpGeometry* g) {
  g->scratch = 0;
  g->ping_pong = 0;
  g->smem = 0;
  g->halo = 0;
  g->sub = tile_n <= 32;
  if (g->sub) {  // 32 / tile_n rows a warp
    const int per = 32 / tile_n;
    g->elems = 1;
    g->group = divisor_at_most(rows, 8 * per);
    g->threads = 32 * ((g->group + per - 1) / per);
    return;
  }
  if (tile_n <= kRowWarpCols) {
    g->elems = tile_n / 32;
    g->group = divisor_at_most(rows, 8);
    g->threads = 32 * g->group;
    return;
  }
  const int spr = tile_n / kRowWarpCols;
  g->elems = 32;
  g->halo = kHalo;
  g->group = divisor_at_most(rows, spr >= 8 ? 1 : 8 / spr);
  g->threads = 32 * g->group * spr;
  const size_t pair = 2 * sizeof(float) * static_cast<size_t>(g->group) * tile_n;
  const size_t carry = sizeof(float) * 2 * g->group;
  if (2 * pair + carry <= kSmemLimit) {
    g->ping_pong = 1;
    g->smem = 2 * pair + carry;
  } else if (pair + carry <= kSmemLimit) {
    g->smem = pair + carry;
  } else {  // two pairs in the global scratch: one barrier a stage
    g->ping_pong = 1;
    g->scratch = 1;
    g->smem = carry;
  }
}

bool warp_tile(int rows, int tile_n) {
  return rows >= 1 && is_pow2(tile_n) && tile_n >= kWarpMinTile &&
         tile_n <= kWarpMaxTile &&
         static_cast<long long>(rows) * tile_n <= kWarpMaxTile;
}

bool warp_geometry(int rows, int tile_n, const int* fan_in, int n_stages,
                   WarpGeometry* g) {
  if (!warp_tile(rows, tile_n) || n_stages < 1 || n_stages > kMaxStages)
    return false;
  WarpStages& st = g->st;
  st.n_shfl = st.n_big = 0;
  int stride = 1, reach = 0;
  for (int t = 0; t < n_stages; ++t) {
    const int f = fan_in[t];
    if (f != 2 && f != 4 && f != 8) return false;
    if (stride < 32) {
      const bool ok = f == 2 || (f == 4 && (stride == 1 || stride == 4 ||
                                            stride == 8 || stride == 16)) ||
                      (f == 8 && (stride == 1 || stride == 8));
      if (!ok || st.n_shfl == kMaxShflStages || st.n_big > 0) return false;
      st.shfl_f[st.n_shfl] = f;
      st.shfl_s[st.n_shfl] = stride;
      ++st.n_shfl;
      reach += (f - 1) * stride;
    } else {
      st.big_f[st.n_big] = f;
      st.big_s[st.n_big] = stride;
      ++st.n_big;
    }
    stride *= f;
  }
  if (stride != tile_n) return false;
  if (tile_n > kRowWarpCols && reach > 32 * kHalo - 1) return false;
  warp_layout(rows, tile_n, g);
  return true;
}

template <typename T, int E, int H, int MAXT, bool PROD, bool SUB = false>
cudaError_t launch_warp(const void* a, const void* b, void* h, void* prod,
                        long long batch, long long n, int rows, int tile_n,
                        const WarpGeometry& g, int gate, float* scratch,
                        cudaStream_t stream) {
  if (g.threads > MAXT) return cudaErrorInvalidValue;
  auto kernel = linrec_warp_kernel<T, E, H, MAXT, PROD, SUB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  const long long blocks = batch / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(blocks), g.threads, g.smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      static_cast<T*>(prod), n, rows, tile_n, g.group, g.st, gate,
      g.ping_pong, g.scratch ? scratch : nullptr);
  return cudaGetLastError();
}

// The chunk kernel (PROD) has the geometries of the tiles the admitted
// h100 plans give it (128 ... 16384 columns): no sub-warp rows, no E = 2,
// no 1024-thread blocks (the 32768-column tile).  The wrapper's route
// function (linrec_route) sends the others to the block kernel.
template <typename T, bool PROD>
cudaError_t dispatch_warp(const void* a, const void* b, void* h, void* prod,
                          long long batch, long long n, int rows, int tile_n,
                          const WarpGeometry& g, int gate, float* scratch,
                          cudaStream_t stream) {
#define REPRO_WARP_ARGS \
  a, b, h, prod, batch, n, rows, tile_n, g, gate, scratch, stream
  if constexpr (PROD) {
    if (g.sub || (g.halo && g.threads > 512) || (!g.halo && g.elems < 4))
      return cudaErrorInvalidValue;
  } else {
    if (g.halo && g.threads > 512)
      return launch_warp<T, 32, kHalo, 1024, PROD>(REPRO_WARP_ARGS);
    if (g.sub) return launch_warp<T, 1, 0, 256, PROD, true>(REPRO_WARP_ARGS);
    if (g.elems == 2) return launch_warp<T, 2, 0, 256, PROD>(REPRO_WARP_ARGS);
  }
  if (g.halo) return launch_warp<T, 32, kHalo, 512, PROD>(REPRO_WARP_ARGS);
  switch (g.elems) {
    case 4: return launch_warp<T, 4, 0, 256, PROD>(REPRO_WARP_ARGS);
    case 8: return launch_warp<T, 8, 0, 256, PROD>(REPRO_WARP_ARGS);
    case 16: return launch_warp<T, 16, 0, 256, PROD>(REPRO_WARP_ARGS);
    case 32: return launch_warp<T, 32, 0, 256, PROD>(REPRO_WARP_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_WARP_ARGS
}

}  // namespace

extern "C" {

// Floats of global scratch a linrec kernel needs for this tile and batch
// (0 when its stage planes fit in shared memory), or -1 for a tile the
// kernel does not take.  route: 0 = block (repro_scan_linrec), 1 = warp
// (repro_scan_linrec_warp).
long long repro_linrec_scratch(long long batch, int rows, int tile_n,
                               int route) {
  if (route == 1) {
    if (!warp_tile(rows, tile_n)) return -1;
    WarpGeometry g;
    warp_layout(rows, tile_n, &g);
    return g.scratch ? (batch / rows) * 4LL * g.group * tile_n : 0;
  }
  int geometry[3];
  if (route != 0 || linrec_geometry(rows, tile_n, geometry)) return -1;
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

// The warp kernel (route "warp"): same arguments and contract as
// repro_scan_linrec, with prod non-null exactly when carry_on = 0 and
// scratch repro_linrec_scratch(..., 1) floats; returns
// cudaErrorInvalidValue for a tile it does not take (not a power of two
// from 2 to 32768 columns, or from 128 to 16384 for the chunk kernel,
// rows * tile_n above 32768, a fan-in other than 2, 4 and 8, a shuffle
// stage it does not specialise, a halo reach above 63).
int repro_scan_linrec_warp(const void* a, const void* b, void* h, void* prod,
                           int dtype, long long batch, long long n, int rows,
                           int tile_n, const int* fan_in, int n_stages,
                           int gate, int carry_on, float* scratch,
                           void* stream) {
  if (rows < 1 || tile_n < 1 || batch % rows || n % tile_n ||
      (carry_on == 0) != (prod != nullptr))
    return cudaErrorInvalidValue;
  WarpGeometry g;
  if (!warp_geometry(rows, tile_n, fan_in, n_stages, &g))
    return cudaErrorInvalidValue;
  if (g.scratch && scratch == nullptr) return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return carry_on
               ? dispatch_warp<float, false>(a, b, h, prod, batch, n, rows,
                                             tile_n, g, gate, scratch, strm)
               : dispatch_warp<float, true>(a, b, h, prod, batch, n, rows,
                                            tile_n, g, gate, scratch, strm);
  if (dtype == 1)
    return carry_on ? dispatch_warp<__nv_bfloat16, false>(
                          a, b, h, prod, batch, n, rows, tile_n, g, gate,
                          scratch, strm)
                    : dispatch_warp<__nv_bfloat16, true>(
                          a, b, h, prod, batch, n, rows, tile_n, g, gate,
                          scratch, strm);
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
