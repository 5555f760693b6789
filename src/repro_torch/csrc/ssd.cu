// Hand-written Hopper kernels for the Mamba-2 SSD (state-space dual),
// chunked form.
//
//   repro_ssd_intra_tiled, repro_ssd_intra
//                    replace repro/kernels/ssd/kernel.py ssd_intra_pallas
//                    (phase A);
//   repro_ssd_state_apply_tiled, repro_ssd_apply (fused = 1)
//                    replace ssd_state_apply_pallas (phases B + C);
//   repro_ssd_apply_entry_tiled, repro_ssd_apply (fused = 0)
//                    replace ssd_apply_entry_pallas (phase C).
//
// The *_tiled kernels (route "tiled", described below the earlier ones)
// are the redesign for Hopper; the wrappers take them for S and P
// multiples of 8 with S <= 128 (phase A also P <= 64, chunk <= 2048; the
// unfused phase C P <= 64) and the earlier kernels (route "block") for
// every other shape.
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py).  Every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or the error of the call that failed first).
//
// Layout.  Rows bh < BH of x / y (BH, L, P) and a (BH, L), in f32 or bf16;
// b and c are (G, L, S), G | BH, and row bh reads group bh / (BH / G): one
// (L, S) pair shared by a sequence's heads is read in place, never
// broadcast into (BH, L, S) copies.  A chunk is Q = chunk consecutive
// positions; nc = L / Q.  Compute, carries and the a_chunk / state /
// entry tensors are f32; y is written in the input type.
//
// Rounding.  Every dot product is a chain of __fmaf_rn in ascending index
// order from 0; every other multiply, add and subtract is __fmul_rn /
// __fadd_rn / __fsub_rn (no contraction); exp and log are the precise
// expf / logf.  The log-decay prefix la_t = la_{t-1} + log(max(a_t,
// 1e-30)) is summed one step after another (by one thread, or by every
// lane of one warp adding the same values in the same order).  The plain
// versions (repro_torch/kernels/ssd/kernel.py) follow the same order, with
// an exact emulation of the fused multiply-add.
//
// repro_ssd_intra (route "block") — what it computes, per (row, chunk):
//   score[t, s] = (c_t . b_s) * exp(la_t - la_s)  for s <= t
//   y[t, p]     = sum_s score[t, s] x[s, p]
//   a_chunk     = exp(la[Q-1])
//   state[k, p] = sum_s (b[s, k] exp(la[Q-1] - la_s)) x[s, p]
// in three launches on the stream:
//   1. the la prefix per (row, chunk) into an f32 scratch (BH, L) the
//      wrapper allocates, and a_chunk;
//   2. y: one block per (row, chunk, 64-row t tile, 64-column P tile).  It
//      never holds a Q x Q tile: it walks the 64-wide s tiles at or below
//      its t tile, builds the 64 x 64 score tile from S-length dots (b and
//      c staged 32 state columns at a time), applies the decay and the
//      mask (pairs s > t are set to 0 without an exp), and accumulates the
//      64 x 64 output in registers (4 x 4 per thread).  Any Q works: the
//      block count grows with Q / 64 and the work per block with its t
//      tile's index (the masked triangle);
//   3. state: one block per (row, chunk, 64-row k tile, 64-column P tile),
//      a reduction over the chunk's Q positions, 32 at a time.
// What bounds it on the card: operations.  The masked scores cost
// Q (S + P) multiply-adds per output row pair of a chunk, so the work
// grows linearly with Q while the bytes stay fixed; at the chunk lengths
// the tuner picks (128 ... 2048) the f32 CUDA-core rate bounds it.  Shared
// memory staging (33 KB a block), 4 x 4 register tiles; tensor cores and
// TMA are later work.
//
// repro_ssd_apply (route "block" for both) — per (row, chunk), with
// h the chunk's entry state:
//   out[t, p] = y_intra[t, p] + (c_t . h[:, p]) * exp(la_t)
// fused = 1 walks the chunks in order inside the block, with h the f32
// (S, 32) carry slice in shared memory: h_{-1} = 0, h_j = a_chunk_j h_{j-1}
// + state_j (one __fmaf_rn).  The TPU kernel's sequential chunk axis is
// this loop; the grid is (row, 32-column P tile), so every chunk count,
// odd included, runs.  fused = 0 reads h = entry[row, chunk] and the grid
// is (row x chunk, P tile).  What bounds it: bytes (y_intra, c and a read,
// out written, the state / entry read once); the dots over S are Q S P
// multiply-adds per chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int kTile = 64;        // t rows / s columns / k rows per tile
constexpr int kKc = 32;          // state columns staged per pass
constexpr int kSt = 32;          // positions staged per pass (state)
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kLaThreads = 128;  // positions per pass of the la prefix
constexpr int kApplyCols = 32;   // P columns per apply block
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// log(max(a, 1e-30)); a NaN passes through, as in torch.clamp_min
__device__ __forceinline__ float clamped_log(float a) {
  return logf(a < 1e-30f ? 1e-30f : a);
}

// ---------------------------------------------------------------------------
// repro_ssd_intra, launch 1: the la prefix of every (row, chunk)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kLaThreads)
    ssd_la_kernel(const T* __restrict__ a, float* __restrict__ la,
                  float* __restrict__ a_chunk, long long L, int Q) {
  __shared__ float lg[kLaThreads];
  const long long base = static_cast<long long>(blockIdx.x) * Q;  // row * L + j * Q
  float run = 0.0f;
  for (int t0 = 0; t0 < Q; t0 += kLaThreads) {
    const int t = t0 + threadIdx.x;
    if (t < Q) lg[threadIdx.x] = clamped_log(to_f32(a[base + t]));
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n = Q - t0 < kLaThreads ? Q - t0 : kLaThreads;
      for (int i = 0; i < n; ++i) {
        run = __fadd_rn(run, lg[i]);
        la[base + t0 + i] = run;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) a_chunk[blockIdx.x] = expf(run);
}

// ---------------------------------------------------------------------------
// repro_ssd_intra, launch 2: y
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_y_kernel(const T* __restrict__ x, const T* __restrict__ b,
                       const T* __restrict__ c, const float* __restrict__ la,
                       T* __restrict__ y, long long L, int P, int S, int Q,
                       int nc, int rows_per_group) {
  // phase 1 (scores): c_s[64][33] and b_s[64][33]; phase 2 (apply):
  // sc_s[64][65] and x_s[64][64] — the two phases share the buffer
  __shared__ float buf[kTile * (kTile + 1) + kTile * kTile];
  __shared__ float la_t[kTile];
  __shared__ float la_s[kTile];
  float* c_s = buf;
  float* b_s = buf + kTile * (kKc + 1);
  float* sc_s = buf;
  float* x_s = buf + kTile * (kTile + 1);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long row = blockIdx.x / nc;
  const int j = blockIdx.x % nc;
  const int t0 = blockIdx.y * kTile;
  const int p0 = blockIdx.z * kTile;
  const long long pos0 = static_cast<long long>(j) * Q;  // chunk start
  const T* xr = x + (row * L + pos0) * P;
  const long long grp = row / rows_per_group;
  const T* br = b + (grp * L + pos0) * S;
  const T* cr = c + (grp * L + pos0) * S;
  const float* lr = la + row * L + pos0;

  if (tid < kTile) la_t[tid] = t0 + tid < Q ? lr[t0 + tid] : 0.0f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int s0 = 0; s0 <= t0; s0 += kTile) {
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) sc[i][q] = 0.0f;
    for (int kc = 0; kc < S; kc += kKc) {
      __syncthreads();  // the previous pass is done with buf
      if (kc == 0 && tid < kTile)
        la_s[tid] = s0 + tid < Q ? lr[s0 + tid] : 0.0f;
      for (int e = tid; e < kTile * kKc; e += kThreads) {
        const int r = e / kKc, kk = e % kKc;
        const bool kin = kc + kk < S;
        c_s[r * (kKc + 1) + kk] =
            kin && t0 + r < Q ? to_f32(cr[static_cast<long long>(t0 + r) * S + kc + kk])
                              : 0.0f;
        b_s[r * (kKc + 1) + kk] =
            kin && s0 + r < Q ? to_f32(br[static_cast<long long>(s0 + r) * S + kc + kk])
                              : 0.0f;
      }
      __syncthreads();
      const int kn = S - kc < kKc ? S - kc : kKc;
      for (int kk = 0; kk < kn; ++kk) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = c_s[(ty + 16 * i) * (kKc + 1) + kk];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = b_s[(tx + 16 * q) * (kKc + 1) + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) sc[i][q] = __fmaf_rn(cv[i], bv[q], sc[i][q]);
      }
    }
    __syncthreads();  // scores done with c_s / b_s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int s = s0 + tx + 16 * q;
        float v = 0.0f;
        if (s <= t && t < Q)
          v = __fmul_rn(sc[i][q],
                        expf(__fsub_rn(la_t[ty + 16 * i], la_s[tx + 16 * q])));
        sc_s[(ty + 16 * i) * (kTile + 1) + tx + 16 * q] = v;
      }
    }
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, p = e % kTile;
      x_s[e] = s0 + r < Q && p0 + p < P
                   ? to_f32(xr[static_cast<long long>(s0 + r) * P + p0 + p])
                   : 0.0f;
    }
    __syncthreads();
    const int sn = Q - s0 < kTile ? Q - s0 : kTile;
    for (int ss = 0; ss < sn; ++ss) {
      float sv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sc_s[(ty + 16 * i) * (kTile + 1) + ss];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = x_s[ss * kTile + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = __fmaf_rn(sv[i], xv[q], acc[i][q]);
    }
  }

  T* yr = y + (row * L + pos0) * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= Q) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + tx + 16 * q;
      if (p < P) from_f32(yr + static_cast<long long>(t) * P + p, acc[i][q]);
    }
  }
}

// ---------------------------------------------------------------------------
// repro_ssd_intra, launch 3: the chunk state
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_intra_state_kernel(const T* __restrict__ x, const T* __restrict__ b,
                           const float* __restrict__ la,
                           float* __restrict__ state, long long L, int P,
                           int S, int Q, int nc, int rows_per_group) {
  __shared__ float bw_s[kSt * kTile];
  __shared__ float x_s[kSt * kTile];
  __shared__ float dec_s[kSt];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const long long row = blockIdx.x / nc;
  const int j = blockIdx.x % nc;
  const int k0 = blockIdx.y * kTile;
  const int p0 = blockIdx.z * kTile;
  const long long pos0 = static_cast<long long>(j) * Q;
  const T* xr = x + (row * L + pos0) * P;
  const T* br = b + ((row / rows_per_group) * L + pos0) * S;
  const float* lr = la + row * L + pos0;
  const float end = lr[Q - 1];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int s0 = 0; s0 < Q; s0 += kSt) {
    __syncthreads();  // the previous pass is done with the tiles
    if (tid < kSt)
      dec_s[tid] = s0 + tid < Q ? expf(__fsub_rn(end, lr[s0 + tid])) : 0.0f;
    __syncthreads();
    for (int e = tid; e < kSt * kTile; e += kThreads) {
      const int r = e / kTile, col = e % kTile;
      const bool s_in = s0 + r < Q;
      bw_s[e] = s_in && k0 + col < S
                    ? __fmul_rn(to_f32(br[static_cast<long long>(s0 + r) * S + k0 + col]),
                                dec_s[r])
                    : 0.0f;
      x_s[e] = s_in && p0 + col < P
                   ? to_f32(xr[static_cast<long long>(s0 + r) * P + p0 + col])
                   : 0.0f;
    }
    __syncthreads();
    const int sn = Q - s0 < kSt ? Q - s0 : kSt;
    for (int ss = 0; ss < sn; ++ss) {
      float bv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) bv[i] = bw_s[ss * kTile + ty + 16 * i];
#pragma unroll
      for (int q = 0; q < 4; ++q) xv[q] = x_s[ss * kTile + tx + 16 * q];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = __fmaf_rn(bv[i], xv[q], acc[i][q]);
    }
  }

  float* st = state + (row * nc + j) * static_cast<long long>(S) * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= S) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + tx + 16 * q;
      if (p < P) st[static_cast<long long>(k) * P + p] = acc[i][q];
    }
  }
}

// ---------------------------------------------------------------------------
// repro_ssd_apply: phase C, with (fused) or without the phase-B carry
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_apply_kernel(const T* __restrict__ y_intra, const T* __restrict__ a,
                     const T* __restrict__ c,
                     const float* __restrict__ a_chunk,
                     const float* __restrict__ state, T* __restrict__ out,
                     long long L, int P, int S, int Q, int nc,
                     int rows_per_group, int fused) {
  extern __shared__ float smem[];
  float* h_s = smem;                               // (S, kApplyCols)
  float* c_s = h_s + S * kApplyCols;               // (kTile, kKc + 1)
  float* lg_s = c_s + kTile * (kKc + 1);           // (kTile)
  float* la_s = lg_s + kTile;                      // (kTile)

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int chunks = fused ? nc : 1;
  const long long row = fused ? blockIdx.x : blockIdx.x / nc;
  const int j_first = fused ? 0 : blockIdx.x % nc;
  const int p0 = blockIdx.y * kApplyCols;
  const long long grp = row / rows_per_group;
  const long long sp = static_cast<long long>(S) * P;

  // the entry state of the first chunk: zero (fused) or entry[row, j]
  const float* ent = state + (row * nc + j_first) * sp;
  for (int e = tid; e < S * kApplyCols; e += kThreads) {
    const int k = e / kApplyCols, p = e % kApplyCols;
    h_s[e] = !fused && p0 + p < P ? ent[static_cast<long long>(k) * P + p0 + p]
                                  : 0.0f;
  }
  __syncthreads();

  for (int jj = 0; jj < chunks; ++jj) {
    const int j = j_first + jj;
    const long long pos0 = static_cast<long long>(j) * Q;
    const T* yr = y_intra + (row * L + pos0) * P;
    const T* ar = a + row * L + pos0;
    const T* cr = c + (grp * L + pos0) * S;
    T* outr = out + (row * L + pos0) * P;
    float run = 0.0f;
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      if (tid < kTile) lg_s[tid] = t0 + tid < Q ? clamped_log(to_f32(ar[t0 + tid])) : 0.0f;
      __syncthreads();
      if (tid == 0) {
        const int n = Q - t0 < kTile ? Q - t0 : kTile;
        for (int i = 0; i < n; ++i) {
          run = __fadd_rn(run, lg_s[i]);
          la_s[i] = run;
        }
      }
      float acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.0f;
      for (int kc = 0; kc < S; kc += kKc) {
        for (int e = tid; e < kTile * kKc; e += kThreads) {
          const int r = e / kKc, kk = e % kKc;
          c_s[r * (kKc + 1) + kk] =
              t0 + r < Q && kc + kk < S
                  ? to_f32(cr[static_cast<long long>(t0 + r) * S + kc + kk])
                  : 0.0f;
        }
        __syncthreads();
        const int kn = S - kc < kKc ? S - kc : kKc;
        for (int kk = 0; kk < kn; ++kk) {
          const float h0 = h_s[(kc + kk) * kApplyCols + tx];
          const float h1 = h_s[(kc + kk) * kApplyCols + tx + 16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float cv = c_s[(ty + 16 * i) * (kKc + 1) + kk];
            acc[i][0] = __fmaf_rn(cv, h0, acc[i][0]);
            acc[i][1] = __fmaf_rn(cv, h1, acc[i][1]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty + 16 * i;
        if (t >= Q) continue;
        const float amul = expf(la_s[ty + 16 * i]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int p = p0 + tx + 16 * q;
          if (p >= P) continue;
          const long long o = static_cast<long long>(t) * P + p;
          from_f32(outr + o, __fadd_rn(to_f32(yr[o]), __fmul_rn(acc[i][q], amul)));
        }
      }
      __syncthreads();  // la_s, lg_s and c_s are reused by the next tile
    }
    if (fused) {
      const float ac = a_chunk[row * nc + j];
      const float* st = state + (row * nc + j) * sp;
      for (int e = tid; e < S * kApplyCols; e += kThreads) {
        const int k = e / kApplyCols, p = e % kApplyCols;
        if (p0 + p < P)
          h_s[e] = __fmaf_rn(ac, h_s[e], st[static_cast<long long>(k) * P + p0 + p]);
      }
      __syncthreads();
    }
  }
}

// ===========================================================================
// The tiled kernels (route "tiled"): kernels 8 and 9 redesigned for Hopper
// ===========================================================================
//
// ssd_intra_tiled_kernel — repro_ssd_intra_tiled, kernel 8 in one launch.
// A block owns one (row, chunk, 128-row t panel); the last panels (the
// heaviest: the masked triangle grows with t, and the last panel also
// forms the chunk state) come first in the grid.
//   1. The panel's decay logs are taken lane-parallel, then one warp sums
//      the prefix: every lane adds the same values (shuffled to all lanes)
//      in ascending t, so la is one __fadd_rn chain in the plain version's
//      order.  The first copies are in flight meanwhile.
//   2. c of the panel (128 x S) stays in shared memory; b and x stream in
//      64-row s tiles through a two-stage ring.  One thread asks TMA for
//      each (tensor maps; c and b in boxes of 128-byte rows, 128-byte
//      swizzled, so the 128-bit loads of a warp's register tiles fall on
//      distinct banks), completing on an mbarrier a stage.
//   3. Warp w owns t rows r0 = t0 + 16 w ... r0 + 15; a lane an 8 x 4
//      register tile of the scores (t = r0 + ty + 2 i, s = s0 + tx + 16 j),
//      each one __fmaf_rn chain in ascending k, four k per 128-bit load.
//      The decay and the mask are applied in registers.
//   4. A warp's scores pass through its own 4 KB of shared memory (a
//      __syncwarp, no block barrier) to its 8 x 4 tile of y (t as above, p
//      = 4 tx + jj), which accumulates over the s tiles in ascending s.
//   5. A warp skips the s tiles above its rows, and its y loop stops at its
//      last row: exact for finite x, as fma(+-0, x, acc) == acc (acc starts
//      at +0 and is never -0).
//   6. The last panel streams every s tile of the chunk, so it also forms
//      the state, one chain over s = 0 ... Q-1 per (k, p) (a lane 8 k x 4
//      p), from the staged b (times its decay to the chunk's end) and x: b
//      and x are read from device memory once for it.
// What bounds it: the f32 FMA rate.  One block an SM (209 KB of shared
// memory at S = 128, Q = 2048, f32), eight warps, 96 accumulators a lane.
//
// ssd_state_apply_tiled_kernel — repro_ssd_state_apply_tiled, kernel 9.
// A block owns (row, 32-column P slice) and walks the chunks in order, a
// chunk in 128-row panels.  One producer warp runs a panel ahead: its lane
// 0 asks TMA (tensor maps, cp.async.bulk.tensor) for the panel's c (boxes
// of 128 bytes a row, 128-byte swizzled, so the consumers' 128-bit loads
// of four rows fall on distinct banks), its y slice and, at a chunk's
// end, the chunk's state slice, into a two-stage ring completing on
// mbarriers; its lanes write exp(la) of the panel (the same warp chain as
// above, carried across the chunk's panels; the decays are loaded a panel
// ahead).  Eight consumer warps compute
// out = y + (c . h) * exp(la) from 4 x 4 register tiles (t = tg + 32 i, p
// = 4 pg + jj; one chain in ascending k, 128-bit loads of c and h), then,
// at a chunk's end, advance the carry h = fma(a_chunk, h, state) in the
// registers of the lanes that own it (k = tg + 32 m) and write it to
// shared memory once for the next chunk's products.
// What bounds it: the dots over S and the bytes about equally.
//
// ssd_apply_entry_tiled_kernel — repro_ssd_apply_entry_tiled, kernel 10.
// The chunks are independent, so a block owns one (row, chunk, panel of
// 128 t rows) with all P <= 64 columns: the grid covers every (row,
// chunk) pair, the last panels (the longest decay chains) first, and c
// and the chunk's entry (S, P) are read once a panel.  One thread asks TMA
// (2-D tensor maps) for the panel's c a k box at a time (128-byte swizzled
// boxes of 128-byte rows) together with the entry's rows of that box, each
// box on its own mbarrier, so the products start on the first; and for y.
// The last warp sums the decay chain from the chunk's start to the
// panel's last row (warp_chain: one __fadd_rn chain, the logs
// lane-parallel, the decays a load ahead) and writes exp(la) of the
// panel's rows once; the eight consumer warps meanwhile compute 8 x 4
// register tiles of c . entry (rows r + 2 i, columns 4 tx + jj; one
// __fmaf_rn chain in ascending k, 128-bit loads: 12 shared loads a 128
// FFMA), then add y + acc * exp(la) after a named barrier with that warp.
// Shared memory sets the overlap: two blocks share an SM, so one block's
// copies run under the other's products without a producer ring.  Where y
// would keep a second block off the SM (f32, 128 rows: c 64 KB, entry 32
// KB, y 32 KB), y is only brought into L2 at the start and copied into
// the first c boxes once every consumer is done with them.  (64-row
// panels, two stages' worth a block, were slower at every chunk.)
// What bounds it: the dots over S and the bytes about equally on paper;
// on the card the product loop, whose 48 shared-memory values a lane per
// 128 FFMA keep the FMA pipes below their rate.

constexpr int kPanel = 128;        // t rows of an intra block's panel
constexpr int kSTile = 64;         // s rows of an intra ring stage
constexpr int kWarpRows = 16;      // t rows of one intra warp
constexpr int kTiledThreads = 256;
constexpr int kTiledMaxP = 64;     // pitch of the staged x rows
constexpr int kTiledMaxS = 128;
constexpr int kTiledMaxQ = 2048;
constexpr int kScorePitch = 16;    // a warp's score rows: (kSTile, 16)
constexpr int kApplyRows = 128;    // t rows of an apply ring stage
constexpr int kSlice = 32;         // P columns of an apply block
constexpr int kConsumers = 256;    // apply consumer threads; + one warp

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The decay prefix over 32 positions, lane i holding position i's log (n
// of them valid): every lane adds the same values in ascending order, so
// run is one __fadd_rn chain on every lane.  Returns this lane's prefix.
__device__ __forceinline__ float warp_chain(float lg, int n, float& run,
                                            int lane) {
  float mine = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float v = __shfl_sync(0xffffffffu, lg, i);
    if (i < n) run = __fadd_rn(run, v);
    if (i == lane) mine = run;
  }
  return mine;
}

// ---------------------------------------------------------------------------
// repro_ssd_intra_tiled
// ---------------------------------------------------------------------------

// c and b arrive by TMA in boxes of 128 bytes a row (Box<T>::kK elements),
// 128-byte swizzled: the 16-byte piece j of a box's row r lies at piece
// j ^ (r % 8), so the 128-bit loads of rows r ... r + 7 at one k fall on
// distinct banks
template <typename T>
struct Box {
  static constexpr int kK = 128 / static_cast<int>(sizeof(T));
  static constexpr int kPiece = 16 / static_cast<int>(sizeof(T));
  // the boxes (and their bytes) that cover S columns of `rows` rows
  static __host__ __device__ int count(int S) { return (S + kK - 1) / kK; }
  static __host__ __device__ size_t bytes(int S, int rows) {
    return static_cast<size_t>(count(S)) * rows * 128;
  }
};

// element [r][k .. k + 3] (k a multiple of 4) of a swizzled tile of `rows`
// rows, as 4 floats
template <typename T>
__device__ __forceinline__ float4 ld4_swizzled(const T* tile, int rows, int r,
                                               int k) {
  const int kb = k / Box<T>::kK, kk = k - kb * Box<T>::kK;
  const int piece = (kk / Box<T>::kPiece) ^ (r & 7);
  return ld4(tile + (kb * rows + r) * Box<T>::kK + piece * Box<T>::kPiece +
             kk % Box<T>::kPiece);
}

template <typename T>
__global__ void __launch_bounds__(kTiledThreads, 1)
    ssd_intra_tiled_kernel(const __grid_constant__ CUtensorMap cmap,
                           const __grid_constant__ CUtensorMap bmap,
                           const __grid_constant__ CUtensorMap xmap,
                           const T* __restrict__ a, T* __restrict__ y,
                           float* __restrict__ a_chunk,
                           float* __restrict__ state, long long L, int P,
                           int S, int Q, int nc, int rows_per_group,
                           long long rc, int panels) {
  extern __shared__ __align__(128) unsigned char smem_intra[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_intra);  // c, tile 0, 1
  unsigned char* tiles_at = smem_intra + 128;
  tiles_at += (1024 - (sm90::smem_addr(tiles_at) & 1023)) & 1023;
  const size_t c_bytes = Box<T>::bytes(S, kPanel);
  const size_t b_bytes = Box<T>::bytes(S, kSTile);
  const size_t x_bytes = sizeof(T) * kSTile * kTiledMaxP;
  T* c_s = reinterpret_cast<T*>(tiles_at);             // swizzled (kPanel, S)
  unsigned char* ring = tiles_at + c_bytes;            // 2 x (b, x)
  float* sc_s = reinterpret_cast<float*>(ring + 2 * (b_bytes + x_bytes));
  float* la_s = sc_s + (kTiledThreads / 32) * kSTile * kScorePitch;
  float* dec_s = la_s + panels * kPanel;               // (Q)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ty = lane >> 4, tx = lane & 15;
  // the heaviest panels first
  const int panel = panels - 1 - static_cast<int>(blockIdx.x / rc);
  const long long rcid = blockIdx.x % rc;  // row * nc + chunk
  const long long row = rcid / nc;
  const long long pos0 = (rcid % nc) * Q;
  const int t0 = panel * kPanel;
  const int t_end = min(t0 + kPanel, Q);
  const bool last = t_end == Q;
  const int tiles = (t_end - 1) / kSTile + 1;
  const int grow = static_cast<int>(row / rows_per_group * L + pos0);
  const T* ar = a + row * L + pos0;

  // one thread asks TMA for c of the panel and for the s tiles (b and x)
  // through a two-stage ring, each completing on its own barrier
  auto stage_tile = [&](int n) {
    unsigned char* st = ring + (n & 1) * (b_bytes + x_bytes);
    uint64_t* bar = &bars[1 + (n & 1)];
    sm90::mbar_expect_tx(bar, static_cast<uint32_t>(b_bytes + x_bytes));
    for (int kb = 0; kb < Box<T>::count(S); ++kb)
      sm90::tma_load_2d(st + kb * kSTile * 128, &bmap, bar, kb * Box<T>::kK,
                        grow + n * kSTile);
    sm90::tma_load_2d(st + b_bytes, &xmap, bar, 0,
                      static_cast<int>(row * L + pos0) + n * kSTile);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bars[i], 1);
    sm90::mbar_fence_init();
    sm90::mbar_expect_tx(&bars[0], static_cast<uint32_t>(c_bytes));
    for (int kb = 0; kb < Box<T>::count(S); ++kb)
      sm90::tma_load_2d(tiles_at + kb * kPanel * 128, &cmap, &bars[0],
                        kb * Box<T>::kK, grow + t0);
    stage_tile(0);
  }

  // the decay prefix la[0 .. t_end): the logs lane-parallel, one warp's
  // chain; the last panel also takes each position's decay to the end
  for (int t = tid; t < t_end; t += kTiledThreads)
    la_s[t] = clamped_log(to_f32(ar[t]));
  __syncthreads();
  if (warp == 0) {
    float run = 0.0f;
    for (int base = 0; base < t_end; base += 32) {
      const int t = base + lane;
      const float mine =
          warp_chain(t < t_end ? la_s[t] : 0.0f, t_end - base, run, lane);
      if (t < t_end) la_s[t] = mine;
    }
  }
  __syncthreads();
  if (last) {
    const float end = la_s[Q - 1];
    for (int s = tid; s < Q; s += kTiledThreads)
      dec_s[s] = expf(__fsub_rn(end, la_s[s]));
    if (tid == 0) a_chunk[rcid] = expf(end);
  }

  const int r0 = t0 + warp * kWarpRows;  // the warp's first t row
  const bool rows_in = r0 < t_end;
  const int kq = tid >> 4, px = tid & 15;  // state: k = 8 kq + i, p = 4 px + jj
  const int kread = 8 * kq < S ? 8 * kq : 0;  // lanes past S read k = 0
  float* scw = sc_s + warp * kSTile * kScorePitch;
  float yacc[8][4], sacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) yacc[i][jj] = sacc[i][jj] = 0.0f;

  sm90::mbar_wait(&bars[0], 0);  // c is in
  for (int n = 0; n < tiles; ++n) {
    sm90::mbar_wait(&bars[1 + (n & 1)], (n >> 1) & 1);  // tile n is in
    __syncthreads();  // every warp is done with tile n - 1's stage
    if (tid == 0 && n + 1 < tiles) stage_tile(n + 1);
    const int s0 = n * kSTile;
    const T* bt = reinterpret_cast<const T*>(ring +
                                             (n & 1) * (b_bytes + x_bytes));
    const T* xt = reinterpret_cast<const T*>(ring + (n & 1) * (b_bytes +
                                                               x_bytes) +
                                             b_bytes);

    if (rows_in && s0 < r0 + kWarpRows) {
      // the scores of rows r0 + ty + 2 i against s = s0 + tx + 16 j
      float sc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.0f;
      const int cr = r0 - t0 + ty;  // the lane's first c row
      for (int k = 0; k < S; k += 4) {
        float4 bv[4], cv[8];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bv[jj] = ld4_swizzled(bt, kSTile, tx + 16 * jj, k);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          cv[i] = ld4_swizzled(c_s, kPanel, cr + 2 * i, k);
        // 32 independent chains a step, k ascending in each
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              sc[i][jj] = __fmaf_rn(at(cv[i], kk), at(bv[jj], kk), sc[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int t = r0 + ty + 2 * i;
        const float lt = la_s[t];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int s = s0 + tx + 16 * jj;
          sc[i][jj] = s <= t ? __fmul_rn(sc[i][jj],
                                         expf(__fsub_rn(lt, la_s[s])))
                             : 0.0f;
        }
      }
      // to the warp's score rows: row s - s0, column 8 ty + i
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float* dst = scw + (tx + 16 * jj) * kScorePitch + 8 * ty;
        st4(dst, make_float4(sc[0][jj], sc[1][jj], sc[2][jj], sc[3][jj]));
        st4(dst + 4, make_float4(sc[4][jj], sc[5][jj], sc[6][jj], sc[7][jj]));
      }
      __syncwarp();
      // y over the tile's s up to the warp's last row
      const int sn = min(min(kSTile, r0 + kWarpRows - s0), t_end - s0);
#pragma unroll 4
      for (int sl = 0; sl < sn; ++sl) {
        const float4 lo = ld4(scw + sl * kScorePitch + 8 * ty);
        const float4 hi = ld4(scw + sl * kScorePitch + 8 * ty + 4);
        const float4 xv = ld4(xt + sl * kTiledMaxP + 4 * tx);
        const float sv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            yacc[i][jj] = __fmaf_rn(sv[i], at(xv, jj), yacc[i][jj]);
      }
      __syncwarp();
    }

    if (last) {
      // the state: b times its decay to the end, against x, this tile's s
      const int sn = min(kSTile, Q - s0);
#pragma unroll 4
      for (int sl = 0; sl < sn; ++sl) {
        const float d = dec_s[s0 + sl];
        const float4 b0 = ld4_swizzled(bt, kSTile, sl, kread);
        const float4 b1 = ld4_swizzled(bt, kSTile, sl, kread + 4);
        const float4 xv = ld4(xt + sl * kTiledMaxP + 4 * px);
        const float bw[8] = {__fmul_rn(b0.x, d), __fmul_rn(b0.y, d),
                             __fmul_rn(b0.z, d), __fmul_rn(b0.w, d),
                             __fmul_rn(b1.x, d), __fmul_rn(b1.y, d),
                             __fmul_rn(b1.z, d), __fmul_rn(b1.w, d)};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            sacc[i][jj] = __fmaf_rn(bw[i], at(xv, jj), sacc[i][jj]);
      }
    }
  }

  if (rows_in && 4 * tx < P) {
    T* yr = y + (row * L + pos0) * P + 4 * tx;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = r0 + ty + 2 * i;
      if (t < t_end)
        st4(yr + static_cast<long long>(t) * P,
            make_float4(yacc[i][0], yacc[i][1], yacc[i][2], yacc[i][3]));
    }
  }
  if (last && 4 * px < P) {
    float* st = state + rcid * S * P + 4 * px;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = 8 * kq + i;
      if (k < S)
        st4(st + static_cast<long long>(k) * P,
            make_float4(sacc[i][0], sacc[i][1], sacc[i][2], sacc[i][3]));
    }
  }
}

// ---------------------------------------------------------------------------
// repro_ssd_state_apply_tiled
// ---------------------------------------------------------------------------

// one ring stage (1024-byte aligned): c (Box<T>::count(S) swizzled boxes
// of kApplyRows x 128 bytes), y (kApplyRows, kSlice) in T; the chunk's
// state (S, kSlice) and exp(la) (kApplyRows) in f32
template <typename T>
struct ApplyStage {
  static __host__ __device__ size_t c_bytes(int S) {
    return Box<T>::bytes(S, kApplyRows);
  }
  static constexpr size_t kYBytes = sizeof(T) * kApplyRows * kSlice;
  static __host__ __device__ size_t st_bytes(int S) {
    return sizeof(float) * static_cast<size_t>(S) * kSlice;
  }
  static __host__ __device__ size_t bytes(int S) {
    const size_t b = c_bytes(S) + kYBytes + st_bytes(S) +
                     sizeof(float) * kApplyRows;
    return (b + 1023) / 1024 * 1024;
  }
};

// barriers (128 bytes), the carry slice h (S, kSlice) f32, then the two
// stages from the next 1024-byte boundary
template <typename T>
size_t apply_tiled_smem(int S) {
  return 1024 + 128 + sizeof(float) * static_cast<size_t>(S) * kSlice +
         2 * ApplyStage<T>::bytes(S);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kConsumers + 32, 1)
    ssd_state_apply_tiled_kernel(const __grid_constant__ CUtensorMap cmap,
                                 const __grid_constant__ CUtensorMap ymap,
                                 const __grid_constant__ CUtensorMap smap,
                                 const T* __restrict__ a,
                                 const float* __restrict__ a_chunk,
                                 T* __restrict__ out, long long L, int P,
                                 int S, int Q, int nc, int rows_per_group,
                                 int slices) {
  extern __shared__ __align__(128) unsigned char smem_apply[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_apply);  // 2 stages
  uint64_t* empty = full + 2;                                // 2 stages
  float* h_s = reinterpret_cast<float*>(smem_apply + 128);   // (S, kSlice)
  unsigned char* stages = smem_apply + 128 + sizeof(float) * S * kSlice;
  stages += (1024 - (sm90::smem_addr(stages) & 1023)) & 1023;
  using Stage = ApplyStage<T>;
  const size_t c_bytes = Stage::c_bytes(S);
  const size_t st_bytes = Stage::st_bytes(S);
  const size_t stage_bytes = Stage::bytes(S);

  const int tid = threadIdx.x;
  const long long row = blockIdx.x / slices;
  const int p0 = (blockIdx.x % slices) * kSlice;
  const int pw = min(kSlice, P - p0);  // the slice's columns
  const long long grp = row / rows_per_group;
  const int panels = (Q + kApplyRows - 1) / kApplyRows;

  if (tid == 0) {
    // the producer's expect_tx, and its 32 lanes once exp(la) is written
    sm90::mbar_init(&full[0], 33);
    sm90::mbar_init(&full[1], 33);
    sm90::mbar_init(&empty[0], kConsumers);
    sm90::mbar_init(&empty[1], kConsumers);
    sm90::mbar_fence_init();
  }
  for (int e = tid; e < S * kSlice; e += blockDim.x) h_s[e] = 0.0f;
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp, a panel ahead of the consumers: lane 0 asks TMA
    // for the panel's c boxes, its y box and, at a chunk's end, the
    // chunk's state box; the lanes write exp(la) of the panel
    const int lane = tid - kConsumers;
    float av[kApplyRows / 32];  // the decays of the next panel
    auto load_a = [&](int j, int t0) {
#pragma unroll
      for (int m = 0; m < kApplyRows / 32; ++m) {
        const int t = t0 + 32 * m + lane;
        av[m] = j < nc && t < Q
                    ? to_f32(a[row * L + static_cast<long long>(j) * Q + t])
                    : 1.0f;
      }
    };
    load_a(0, 0);
    const int boxes = Box<T>::count(S);
    float run = 0.0f;
    int n = 0;
    for (int j = 0; j < nc; ++j) {
      const long long pos0 = static_cast<long long>(j) * Q;
      for (int q = 0; q < panels; ++q, ++n) {
        const int s = n & 1;
        const int t0 = q * kApplyRows, rows = min(kApplyRows, Q - t0);
        const bool chunk_end = q == panels - 1;
        float lg[kApplyRows / 32];
#pragma unroll
        for (int m = 0; m < kApplyRows / 32; ++m) lg[m] = clamped_log(av[m]);
        if (q + 1 < panels)
          load_a(j, t0 + kApplyRows);
        else
          load_a(j + 1, 0);
        if (n >= 2) sm90::mbar_wait(&empty[s], ((n >> 1) - 1) & 1);
        unsigned char* st = stages + s * stage_bytes;
        float* am = reinterpret_cast<float*>(st + c_bytes + Stage::kYBytes +
                                             st_bytes);
        if (lane == 0) {
          sm90::mbar_expect_tx(
              &full[s], static_cast<uint32_t>(
                            c_bytes + Stage::kYBytes +
                            (chunk_end ? st_bytes : 0)));
          const int crow = static_cast<int>(grp * L + pos0 + t0);
          for (int kb = 0; kb < boxes; ++kb)
            sm90::tma_load_2d(st + kb * kApplyRows * 128, &cmap, &full[s],
                              kb * Box<T>::kK, crow);
          sm90::tma_load_2d(st + c_bytes, &ymap, &full[s], p0,
                            static_cast<int>(row * L + pos0 + t0));
          if (chunk_end)
            sm90::tma_load_2d(st + c_bytes + Stage::kYBytes, &smap, &full[s],
                              p0, static_cast<int>((row * nc + j) * S));
        }
        if (q == 0) run = 0.0f;
#pragma unroll
        for (int m = 0; m < kApplyRows / 32; ++m) {
          if (32 * m >= rows) break;
          const float mine = warp_chain(lg[m], rows - 32 * m, run, lane);
          if (32 * m + lane < rows) am[32 * m + lane] = expf(mine);
        }
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // the consumers: out rows t = tg + 32 i, columns p0 + 4 pg + jj; the
  // carry h[k][p0 + 4 pg + jj], k = tg + 32 m
  const int tg = tid >> 3, pg = tid & 7;
  float hr[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) hr[m][jj] = 0.0f;
  int n = 0;
  for (int j = 0; j < nc; ++j) {
    const long long pos0 = static_cast<long long>(j) * Q;
    const float ac = j + 1 < nc ? a_chunk[row * nc + j] : 0.0f;
    for (int q = 0; q < panels; ++q, ++n) {
      const int s = n & 1;
      const int t0 = q * kApplyRows, rows = min(kApplyRows, Q - t0);
      sm90::mbar_wait(&full[s], (n >> 1) & 1);
      const unsigned char* st = stages + s * stage_bytes;
      const T* c_st = reinterpret_cast<const T*>(st);
      const T* y_st = reinterpret_cast<const T*>(st + c_bytes);
      const float* s_st =
          reinterpret_cast<const float*>(st + c_bytes + Stage::kYBytes);
      const float* am = reinterpret_cast<const float*>(
          st + c_bytes + Stage::kYBytes + st_bytes);
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
#pragma unroll 2
      for (int k = 0; k < S; k += 4) {
        float4 hv[4], cv[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hv[kk] = ld4(h_s + (k + kk) * kSlice + 4 * pg);
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = ld4_swizzled(c_st, kApplyRows, tg + 32 * i, k);
        // 16 independent chains a step, k ascending in each
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][jj] = __fmaf_rn(at(cv[i], kk), at(hv[kk], jj),
                                     acc[i][jj]);
      }
      if (4 * pg < pw) {
        T* outr = out + (row * L + pos0 + t0) * P + p0 + 4 * pg;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = tg + 32 * i;
          if (t >= rows) continue;
          const float4 yv = ld4(y_st + t * kSlice + 4 * pg);
          const float m = am[t];
          st4(outr + static_cast<long long>(t) * P,
              make_float4(__fadd_rn(yv.x, __fmul_rn(acc[i][0], m)),
                          __fadd_rn(yv.y, __fmul_rn(acc[i][1], m)),
                          __fadd_rn(yv.z, __fmul_rn(acc[i][2], m)),
                          __fadd_rn(yv.w, __fmul_rn(acc[i][3], m))));
        }
      }
      if (q == panels - 1 && j + 1 < nc) {
        consumer_sync();  // every consumer is done reading h_{j-1}
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int k = tg + 32 * m;
          if (k >= S) continue;
          const float4 sv = ld4(s_st + k * kSlice + 4 * pg);
          hr[m][0] = __fmaf_rn(ac, hr[m][0], sv.x);
          hr[m][1] = __fmaf_rn(ac, hr[m][1], sv.y);
          hr[m][2] = __fmaf_rn(ac, hr[m][2], sv.z);
          hr[m][3] = __fmaf_rn(ac, hr[m][3], sv.w);
          st4(h_s + k * kSlice + 4 * pg,
              make_float4(hr[m][0], hr[m][1], hr[m][2], hr[m][3]));
        }
        consumer_sync();  // h_j is in shared memory
      }
      sm90::mbar_arrive(&empty[s]);
    }
  }
}

// ---------------------------------------------------------------------------
// repro_ssd_apply_entry_tiled
// ---------------------------------------------------------------------------

// an entry-apply block: kEntryRows t rows x all P <= 64 columns, a
// consumer lane an 8 x 4 tile (kEntryConsumers threads), and one warp for
// the copies and the decay chain
constexpr int kEntryRows = 128;
constexpr int kEntryConsumers = kEntryRows * kTiledMaxP / 32;

// shared memory an entry-apply block may use so that two share an SM
constexpr size_t kTwoBlockSmem = 115712;

__host__ __device__ inline size_t round1024(size_t n) {
  return (n + 1023) / 1024 * 1024;
}

// bytes of the c region: the panel's swizzled c boxes, or (y_after) the
// larger of those and the y panel, which then reuses the space
template <typename T>
__host__ __device__ size_t entry_region(int rows, int S, int P,
                                        bool y_after) {
  const size_t c = Box<T>::bytes(S, rows);
  const size_t y = sizeof(T) * static_cast<size_t>(rows) * P;
  return y_after && y > c ? y : c;
}

// the entry's rows as they arrive: one box of Box<T>::kK rows beside each
// c box (the last may run past S)
template <typename T>
__host__ __device__ size_t entry_bytes(int S, int P) {
  return sizeof(float) * static_cast<size_t>(Box<T>::count(S)) *
         Box<T>::kK * P;
}

// barriers (128 bytes) and exp(la) of the panel's rows, then from the next
// 1024-byte boundary the c region, the entry boxes f32 and, unless
// y_after, the y panel (rows, P) in T
template <typename T>
size_t entry_tiled_smem(int rows, int S, int P, bool y_after) {
  return 1024 + 128 + sizeof(float) * rows +
         entry_region<T>(rows, S, P, y_after) +
         round1024(entry_bytes<T>(S, P)) +
         (y_after ? 0 : sizeof(T) * static_cast<size_t>(rows) * P);
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(kEntryConsumers + 32, 2)
    ssd_apply_entry_tiled_kernel(const __grid_constant__ CUtensorMap cmap,
                                 const __grid_constant__ CUtensorMap ymap,
                                 const __grid_constant__ CUtensorMap emap,
                                 const T* __restrict__ a, T* __restrict__ out,
                                 long long L, int P, int S, int Q, int nc,
                                 int rows_per_group, int panels,
                                 int y_after) {
  constexpr int kRows = kEntryRows;
  constexpr int kC = kEntryConsumers;
  constexpr int kK = Box<T>::kK;
  constexpr size_t kBoxBytes = static_cast<size_t>(kRows) * 128;
  extern __shared__ __align__(128) unsigned char smem_entry[];
  // one barrier a k box (c and the entry's rows), then y's
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_entry);
  float* am = reinterpret_cast<float*>(smem_entry + 128);     // (kRows)
  unsigned char* tiles = smem_entry + 128 + sizeof(float) * kRows;
  tiles += (1024 - (sm90::smem_addr(tiles) & 1023)) & 1023;
  const int boxes = Box<T>::count(S);
  uint64_t* ybar = bars + boxes;
  const size_t y_bytes = sizeof(T) * static_cast<size_t>(kRows) * P;
  // with y_after, y lands in the first y_boxes c boxes once every consumer
  // is done with them
  const int y_boxes =
      y_after ? min(boxes, static_cast<int>((y_bytes + kBoxBytes - 1) /
                                            kBoxBytes))
              : 0;
  unsigned char* e_at = tiles + entry_region<T>(kRows, S, P, y_after);
  unsigned char* y_at =
      y_after ? tiles : e_at + round1024(entry_bytes<T>(S, P));

  const int tid = threadIdx.x;
  // the last panels (the longest decay chains) first
  const long long rc = gridDim.x / panels;
  const long long rcid = blockIdx.x % rc;  // row * nc + chunk
  const int t0 = (panels - 1 - static_cast<int>(blockIdx.x / rc)) * kRows;
  const int rows = min(kRows, Q - t0);     // the panel's rows
  const long long row = rcid / nc;
  const long long pos0 = (rcid % nc) * Q;
  const int yrow = static_cast<int>(row * L + pos0 + t0);

  if (tid == kC) {
    // one thread asks TMA for each k box (c of the panel and the entry's
    // rows) on its own barrier, so the products start on the first; y on
    // its own, or, with y_after, only into L2 for now
    for (int kb = 0; kb <= boxes; ++kb) sm90::mbar_init(&bars[kb], 1);
    sm90::mbar_fence_init();
    const int crow = static_cast<int>(row / rows_per_group * L + pos0 + t0);
    for (int kb = 0; kb < boxes; ++kb) {
      sm90::mbar_expect_tx(&bars[kb], static_cast<uint32_t>(
                                          kBoxBytes + sizeof(float) * kK * P));
      sm90::tma_load_2d(tiles + kb * kBoxBytes, &cmap, &bars[kb], kb * kK,
                        crow);
      sm90::tma_load_2d(e_at + sizeof(float) * kb * kK * P, &emap, &bars[kb],
                        0, static_cast<int>(rcid * S + kb * kK));
    }
    if (y_after) {
      sm90::tma_prefetch_2d(&ymap, 0, yrow);
    } else {
      sm90::mbar_expect_tx(ybar, static_cast<uint32_t>(y_bytes));
      sm90::tma_load_2d(y_at, &ymap, ybar, 0, yrow);
    }
  }
  __syncthreads();  // the barriers are initialised

  if (tid >= kC) {
    // the decay chain from the chunk's start to the panel's last row, 256
    // positions of decays a load (the next 256 in flight while these are
    // summed); exp(la) of the panel's rows to shared memory, then the
    // consumers are told
    const int lane = tid - kC;
    const T* ar = a + row * L + pos0;
    const int t_end = t0 + rows;
    float av[8], next[8];
    auto load = [&](float (&v)[8], int base) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int t = base + 32 * m + lane;
        v[m] = t < t_end ? to_f32(ar[t]) : 1.0f;
      }
    };
    load(av, 0);
    float run = 0.0f;
    for (int base = 0; base < t_end; base += 256) {
      load(next, base + 256);
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int b = base + 32 * m;
        if (b >= t_end) break;
        const float lg = clamped_log(av[m]);
        if (b + 32 <= t0) {
          // before the panel: the sum only (n = 32 and no prefix read, so
          // the inlined chain drops its per-lane selects)
          warp_chain(lg, 32, run, lane);
        } else {
          const float mine = warp_chain(lg, t_end - b, run, lane);
          if (b + lane >= t0 && b + lane < t_end)
            am[b + lane - t0] = expf(mine);
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) av[m] = next[m];
    }
    named_arrive(1, kC + 32);
    return;
  }

  // the consumers: rows r + 2 i of the panel (warp w's rows 16 w ... 16 w
  // + 15), columns 4 tx + jj; lanes past P read the last four columns
  const int warp = tid >> 5, lane = tid & 31;
  const int r = warp * kWarpRows + (lane >> 4);
  const int tx = lane & 15;
  const int pc = min(4 * tx, P - 4);
  const T* c_s = reinterpret_cast<const T*>(tiles);
  const float* e_s = reinterpret_cast<const float*>(e_at);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
  for (int kb = 0; kb < boxes; ++kb) {
    sm90::mbar_wait(&bars[kb], 0);  // k box kb is in
    const int k_end = min(S, (kb + 1) * kK);
    for (int k = kb * kK; k < k_end; k += 4) {
      float4 ev[4], cv[8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ev[kk] = ld4(e_s + (k + kk) * P + pc);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cv[i] = ld4_swizzled(c_s, kRows, r + 2 * i, k);
      // 32 independent chains a step, k ascending in each
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] = __fmaf_rn(at(cv[i], kk), at(ev[kk], jj), acc[i][jj]);
    }
    if (kb + 1 == y_boxes) {
      named_sync(2, kC);  // every consumer is done with y's boxes
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        sm90::mbar_expect_tx(ybar, static_cast<uint32_t>(y_bytes));
        sm90::tma_load_2d(y_at, &ymap, ybar, 0, yrow);
      }
    }
  }
  sm90::mbar_wait(ybar, 0);  // y is in
  named_sync(1, kC + 32);    // exp(la) is in
  if (4 * tx < P) {
    const T* y_s = reinterpret_cast<const T*>(y_at);
    T* outr = out + static_cast<long long>(yrow) * P + 4 * tx;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = r + 2 * i;
      if (t >= rows) continue;
      const float4 yv = ld4(y_s + t * P + 4 * tx);
      const float m = am[t];
      st4(outr + static_cast<long long>(t) * P,
          make_float4(__fadd_rn(yv.x, __fmul_rn(acc[i][0], m)),
                      __fadd_rn(yv.y, __fmul_rn(acc[i][1], m)),
                      __fadd_rn(yv.z, __fmul_rn(acc[i][2], m)),
                      __fadd_rn(yv.w, __fmul_rn(acc[i][3], m))));
    }
  }
}

unsigned blocks_of(long long n, int tile) {
  return static_cast<unsigned>((n + tile - 1) / tile);
}

template <typename T>
int launch_intra(const void* x, const void* a, const void* b, const void* c,
                 void* y, float* a_chunk, float* state, float* la,
                 long long BH, long long L, int P, int S, int rows_per_group,
                 int Q, cudaStream_t stream) {
  const long long nc = L / Q;
  const long long rc = BH * nc;
  if (rc == 0) return cudaSuccess;
  ssd_la_kernel<T><<<static_cast<unsigned>(rc), kLaThreads, 0, stream>>>(
      static_cast<const T*>(a), la, a_chunk, L, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_y(static_cast<unsigned>(rc), blocks_of(Q, kTile),
                    blocks_of(P, kTile));
  ssd_intra_y_kernel<T><<<grid_y, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b),
      static_cast<const T*>(c), la, static_cast<T*>(y), L, P, S, Q,
      static_cast<int>(nc), rows_per_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_s(static_cast<unsigned>(rc), blocks_of(S, kTile),
                    blocks_of(P, kTile));
  ssd_intra_state_kernel<T><<<grid_s, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(b), la, state, L, P, S,
      Q, static_cast<int>(nc), rows_per_group);
  return cudaGetLastError();
}

template <typename T>
int launch_apply(const void* y_intra, const void* a, const void* c,
                 const float* a_chunk, const float* state, void* out,
                 long long BH, long long L, int P, int S, int rows_per_group,
                 int Q, int fused, cudaStream_t stream) {
  const long long nc = L / Q;
  const long long rows = fused ? BH : BH * nc;
  if (rows == 0) return cudaSuccess;
  const size_t smem = sizeof(float) * (static_cast<size_t>(S) * kApplyCols +
                                       kTile * (kKc + 1) + 2 * kTile);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = ssd_apply_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(rows), blocks_of(P, kApplyCols));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(y_intra), static_cast<const T*>(a),
      static_cast<const T*>(c), a_chunk, state, static_cast<T*>(out), L, P, S,
      Q, static_cast<int>(nc), rows_per_group, fused);
  return cudaGetLastError();
}

template <typename T>
size_t intra_tiled_smem(int S, int Q) {
  const size_t panels = (Q + kPanel - 1) / kPanel;
  return 128 + 1024 + Box<T>::bytes(S, kPanel) +
         2 * (Box<T>::bytes(S, kSTile) + sizeof(T) * kSTile * kTiledMaxP) +
         sizeof(float) * (static_cast<size_t>(kTiledThreads / 32) * kSTile *
                              kScorePitch +
                          panels * kPanel + Q);
}

// a TMA map over a row-major (rows, cols) tensor of T (float or bf16),
// boxes of (box_rows, box_cols)
template <typename T>
int map_rows(CUtensorMap* map, const void* base, uint64_t rows,
             uint64_t cols, uint32_t box_rows, uint32_t box_cols,
             CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {cols, rows};
  const uint32_t box[2] = {box_cols, box_rows};
  return sm90::make_map(map,
                        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        sizeof(T), base, 2, dims, box, swizzle);
}

template <typename T>
int launch_intra_tiled(const void* x, const void* a, const void* b,
                       const void* c, void* y, float* a_chunk, float* state,
                       long long BH, long long L, int P, int S, long long G,
                       int Q, cudaStream_t stream) {
  const long long nc = L / Q;
  const long long rc = BH * nc;
  if (rc == 0) return cudaSuccess;
  const int panels = (Q + kPanel - 1) / kPanel;
  if (rc * panels > 0x7fffffffLL || BH * L > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = intra_tiled_smem<T>(S, Q);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap cmap, bmap, xmap;
  int code = map_rows<T>(&cmap, c, G * L, S, kPanel, Box<T>::kK,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (code == 0)
    code = map_rows<T>(&bmap, b, G * L, S, kSTile, Box<T>::kK,
                       CU_TENSOR_MAP_SWIZZLE_128B);
  if (code == 0)
    code = map_rows<T>(&xmap, x, BH * L, P, kSTile, kTiledMaxP,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (code != 0) return code;
  auto kernel = ssd_intra_tiled_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(rc * panels), kTiledThreads, smem, stream>>>(
      cmap, bmap, xmap, static_cast<const T*>(a), static_cast<T*>(y),
      a_chunk, state, L, P, S, Q, static_cast<int>(nc),
      static_cast<int>(BH / G), rc, panels);
  return cudaGetLastError();
}

template <typename T>
int launch_apply_tiled(const void* y_intra, const void* a, const void* c,
                       const float* a_chunk, const float* state, void* out,
                       long long BH, long long L, int P, int S, long long G,
                       int Q, cudaStream_t stream) {
  const long long nc = L / Q;
  const int slices = (P + kSlice - 1) / kSlice;
  if (BH == 0) return cudaSuccess;
  if (BH * slices > 0x7fffffffLL || BH * nc * S > 0x7fffffffLL ||
      BH * L > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = apply_tiled_smem<T>(S);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap cmap, ymap, smap;
  int code = map_rows<T>(&cmap, c, G * L, S, kApplyRows, Box<T>::kK,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (code == 0)
    code = map_rows<T>(&ymap, y_intra, BH * L, P, kApplyRows, kSlice,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (code == 0)
    code = map_rows<float>(&smap, state, BH * nc * S, P, S, kSlice,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (code != 0) return code;
  auto kernel = ssd_state_apply_tiled_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(BH * slices), kConsumers + 32, smem,
           stream>>>(cmap, ymap, smap, static_cast<const T*>(a), a_chunk,
                     static_cast<T*>(out), L, P, S, Q, static_cast<int>(nc),
                     static_cast<int>(BH / G), slices);
  return cudaGetLastError();
}

template <typename T>
int launch_entry_tiled(const void* y_intra, const void* a, const void* c,
                       const float* entry, void* out, long long BH,
                       long long L, int P, int S, long long G, int Q,
                       cudaStream_t stream) {
  constexpr int kRows = kEntryRows;
  const long long nc = L / Q;
  const int panels = (Q + kRows - 1) / kRows;
  const long long blocks = BH * nc * panels;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL || BH * nc * S > 0x7fffffffLL ||
      BH * L > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  // y gets its own space unless that keeps two blocks off an SM
  bool y_after = entry_tiled_smem<T>(kRows, S, P, false) > kTwoBlockSmem;
  const size_t smem = entry_tiled_smem<T>(kRows, S, P, y_after);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  CUtensorMap cmap, ymap, emap;
  int code = map_rows<T>(&cmap, c, G * L, S, kRows, Box<T>::kK,
                         CU_TENSOR_MAP_SWIZZLE_128B);
  if (code == 0)
    code = map_rows<T>(&ymap, y_intra, BH * L, P, kRows, P,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
  if (code == 0)
    code = map_rows<float>(&emap, entry, BH * nc * S, P, Box<T>::kK, P,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (code != 0) return code;
  auto kernel = ssd_apply_entry_tiled_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kEntryConsumers + 32, smem,
           stream>>>(cmap, ymap, emap, static_cast<const T*>(a),
                     static_cast<T*>(out), L, P, S, Q, static_cast<int>(nc),
                     static_cast<int>(BH / G), panels, y_after ? 1 : 0);
  return cudaGetLastError();
}

// the shapes the tiled kernels take (the wrappers' route functions say the
// same): S and P multiples of 8 (16-byte rows in bf16), S <= 128; the
// intra kernel also P <= 64 and chunk <= 2048, the entry-apply kernel P
// <= 64; every pointer 16-byte aligned
bool bad_tiled(int P, int S, int chunk, bool intra,
               std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return S % 8 || S > kTiledMaxS || P % 8 ||
         (intra && (P > kTiledMaxP || chunk > kTiledMaxQ));
}

bool bad_geometry(long long BH, long long L, int P, int S, long long G,
                  int chunk) {
  return BH < 0 || L < 1 || P < 1 || S < 1 || G < 1 || chunk < 1 ||
         L % chunk || BH % G || BH * (L / chunk) > 0x7fffffffLL ||
         (P + kTile - 1) / kTile > 65535 || (S + kTile - 1) / kTile > 65535 ||
         (chunk + kTile - 1) / kTile > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, a, b, c and y).  x, y: (BH, L, P);
// a: (BH, L); b, c: (G, L, S), G | BH; a_chunk: (BH, nc) f32; state:
// (BH, nc, S, P) f32; la: (BH, L) f32 scratch.  All contiguous on the
// device; chunk | L.
int repro_ssd_intra(const void* x, const void* a, const void* b,
                    const void* c, void* y, float* a_chunk, float* state,
                    float* la, int dtype, long long BH, long long L, int P,
                    int S, long long G, int chunk, void* stream) {
  if (bad_geometry(BH, L, P, S, G, chunk)) return cudaErrorInvalidValue;
  const int rpg = static_cast<int>(BH / G);
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_intra<float>(x, a, b, c, y, a_chunk, state, la, BH, L, P, S,
                               rpg, chunk, strm);
  if (dtype == 1)
    return launch_intra<__nv_bfloat16>(x, a, b, c, y, a_chunk, state, la, BH,
                                       L, P, S, rpg, chunk, strm);
  return cudaErrorInvalidValue;
}

// dtype as above (y_intra, a, c and out).  fused = 1: a_chunk (BH, nc) and
// state (BH, nc, S, P) f32, the chunk states of repro_ssd_intra; fused =
// 0: a_chunk null and state = the entry states (BH, nc, S, P) f32.
int repro_ssd_apply(const void* y_intra, const void* a, const void* c,
                    const float* a_chunk, const float* state, void* out,
                    int dtype, long long BH, long long L, int P, int S,
                    long long G, int chunk, int fused, void* stream) {
  if (bad_geometry(BH, L, P, S, G, chunk) || (fused && a_chunk == nullptr))
    return cudaErrorInvalidValue;
  const int rpg = static_cast<int>(BH / G);
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_apply<float>(y_intra, a, c, a_chunk, state, out, BH, L, P,
                               S, rpg, chunk, fused, strm);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(y_intra, a, c, a_chunk, state, out, BH,
                                       L, P, S, rpg, chunk, fused, strm);
  return cudaErrorInvalidValue;
}

// repro_ssd_intra with the tiled kernel (one launch, no la scratch);
// arguments as repro_ssd_intra's.
int repro_ssd_intra_tiled(const void* x, const void* a, const void* b,
                          const void* c, void* y, float* a_chunk,
                          float* state, int dtype, long long BH, long long L,
                          int P, int S, long long G, int chunk, void* stream) {
  if (bad_geometry(BH, L, P, S, G, chunk) ||
      bad_tiled(P, S, chunk, true, {x, b, c, y, state}))
    return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_intra_tiled<float>(x, a, b, c, y, a_chunk, state, BH, L, P,
                                     S, G, chunk, strm);
  if (dtype == 1)
    return launch_intra_tiled<__nv_bfloat16>(x, a, b, c, y, a_chunk, state,
                                             BH, L, P, S, G, chunk, strm);
  return cudaErrorInvalidValue;
}

// repro_ssd_apply with fused = 1 on the tiled kernel; arguments as
// repro_ssd_apply's.
int repro_ssd_state_apply_tiled(const void* y_intra, const void* a,
                                const void* c, const float* a_chunk,
                                const float* state, void* out, int dtype,
                                long long BH, long long L, int P, int S,
                                long long G, int chunk, void* stream) {
  if (bad_geometry(BH, L, P, S, G, chunk) || a_chunk == nullptr ||
      bad_tiled(P, S, chunk, false, {y_intra, c, state, out}))
    return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_apply_tiled<float>(y_intra, a, c, a_chunk, state, out, BH,
                                     L, P, S, G, chunk, strm);
  if (dtype == 1)
    return launch_apply_tiled<__nv_bfloat16>(y_intra, a, c, a_chunk, state,
                                             out, BH, L, P, S, G, chunk,
                                             strm);
  return cudaErrorInvalidValue;
}

// repro_ssd_apply with fused = 0 on the tiled kernel: entry (BH, nc, S, P)
// f32, the other arguments as repro_ssd_apply's.
int repro_ssd_apply_entry_tiled(const void* y_intra, const void* a,
                                const void* c, const float* entry, void* out,
                                int dtype, long long BH, long long L, int P,
                                int S, long long G, int chunk, void* stream) {
  if (bad_geometry(BH, L, P, S, G, chunk) || P > kTiledMaxP ||
      bad_tiled(P, S, chunk, false, {y_intra, c, entry, out}))
    return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_entry_tiled<float>(y_intra, a, c, entry, out, BH, L, P, S,
                                     G, chunk, strm);
  if (dtype == 1)
    return launch_entry_tiled<__nv_bfloat16>(y_intra, a, c, entry, out, BH,
                                             L, P, S, G, chunk, strm);
  return cudaErrorInvalidValue;
}

}  // extern "C"
