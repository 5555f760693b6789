// Hand-written Hopper kernels for the Mamba-2 SSD (state-space dual),
// chunked form.
//
//   repro_ssd_intra  replaces repro/kernels/ssd/kernel.py ssd_intra_pallas
//                    (phase A);
//   repro_ssd_apply  replaces ssd_state_apply_pallas (fused = 1: phases
//                    B + C) and ssd_apply_entry_pallas (fused = 0: phase C).
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
// 1e-30)) is summed one step after another by one thread.  The plain
// versions (repro_torch/kernels/ssd/kernel.py) follow the same order, with
// an exact emulation of the fused multiply-add.
//
// repro_ssd_intra — what it computes, per (row, chunk):
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
// repro_ssd_apply — per (row, chunk), with h the chunk's entry state:
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

}  // extern "C"
