// Hand-written Hopper kernels for flash attention.
//
//   repro_flash_attention_wgmma  (bf16, the tensor cores) and
//   repro_flash_attention        (f32, the CUDA cores) replace
//                                repro/kernels/attention/kernel.py
//                                flash_attention_pallas (_flash_kernel).
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py).  The
// entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() (or the error of the call that failed first).
//
// What they compute.  Online-softmax attention over flattened rows: q
// (BH, Lq, D), k and v (BH, Lk, D), out in q's type, with f32 scores,
// running max m, denominator l and accumulator acc.  Causal and
// local-window masks come from global positions, the queries sitting in
// the last Lq slots of the key stream (offset Lk - Lq).  It is the TPU
// kernel's function:
//   * the TPU grid (BH, Lq / block_q, Lk / block_k) with a sequential k
//     axis becomes the CUDA grid (BH, Lq / block_q) and a loop over the
//     keys inside the block, because a CUDA grid has no order;
//   * a k-block is skipped when the TPU kernel's `live` test says its
//     whole (block_q, block_k) score tile is masked; every key of a live
//     k-block is processed;
//   * s = (q . k) * scale in f32, masked entries set to -1e30 (not -inf:
//     a row whose first live keys are all masked then gets p = 1 and is
//     wiped by the next rescale, as on the TPU, where -inf would give
//     exp(-inf + inf) = NaN), m_new = max(m, rowmax s), p = exp(s - m_new),
//     alpha = exp(m - m_new), l = l * alpha + sum p, acc = acc * alpha +
//     p . v;
//   * out = acc / max(l, 1e-30).
//
// What bounds it on the card: operations (4 D flops per live (query, key)
// pair; at Lq = Lk = 2048 and D = 64 the pairs outweigh the bytes 300
// to 1).
//
// The bf16 kernel runs the two products on the tensor cores.  A block owns
// block_q query rows and works on them in tiles of 128: two consumer
// warpgroups of 64 rows, Q loaded once a tile by TMA.  One producer
// warpgroup (one thread issues, the registers of the rest go to the
// consumers by setmaxnreg) streams K and V by TMA (128-byte swizzle, head
// dims below 64 zero-filled to 64) through a ring of shared-memory stages of
// kKT keys behind mbarriers.  The live k-blocks form one run of keys (causal
// keeps a prefix, the window a suffix); the steps walk it kKT keys at a
// time, and keys of a step past the run (dead blocks, or past Lk) score
// -inf, so they add nothing, not even in a row that is wholly masked.  Per
// step: S = Q K^T by wgmma m64n{kKT}k16 (both from shared memory), scale and
// masks in registers, row max and sum over each row's quad of threads, one
// rescale (exact online softmax: the TPU rescales once a block_k keys, and
// the two differ only in rounding), then P, rounded to bf16 in registers as
// the A operand (the S accumulator fragment is the A fragment of the next
// product), times V (shared memory, the transpose bit) into O, f32 in
// registers.  block_k decides only which keys are live, as on the TPU:
// inside the run, the step is the kernel's own.
// Footprint: core/space.py flash_wgmma_smem_bytes, fixed per head dim.
//
// The f32 kernel (TF32 would lose f32's accuracy, so it stays off the
// tensor cores) follows the TPU kernel step for step: per live k-block,
// the scores of its whole span, then the rescale.  block_k sets how many
// keys one rescale covers, block_q how many query rows a block owns.  A
// block works on its block_q rows qt at a time (qt = min(block_q, 64,
// 16384 / block_k): the whole block_k span of scores for qt rows is held
// in shared memory, so the row max is known before any p is formed) and
// stages K and V in sub-tiles of kt keys (64, or 32 at head_dim 256), with
// register micro-tiles (4 x 4 scores, 4 output dims x up to 16 rows a
// thread).  Its footprint is core/space.py flash_smem_bytes.  It also
// takes bf16 (converted to f32 on load), which only the tests' record of
// the earlier design calls.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQtMax = 64;             // query rows a block works on at once
constexpr int kScoreFloats = 16384;    // qt x block_k score tile
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use
constexpr float kNegInf = -1e30f;      // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Thread geometry per head dim: the score step is a 16 x 16 thread grid,
// each thread 4 query rows x kKt / 16 keys; the p . v step has kCw column
// threads owning 4 dims each (d = cx + kCw * c) and kTy row threads owning
// kRpt rows each (r = cy + kTy * i).
template <int D>
struct Geo {
  static constexpr int kKt = D <= 128 ? 64 : 32;
  static constexpr int kCw = D / 4;
  static constexpr int kTy = kThreads / kCw;
  static constexpr int kRpt = (kQtMax + kTy - 1) / kTy;
  static constexpr int kKb = kKt / 16;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int lq, int lk,
                 int block_q, int block_k, int qt, int kt, int causal,
                 int window, float scale) {
  using G = Geo<D>;
  constexpr int kLd = D + 1;  // padded row: conflict-free column reads
  extern __shared__ float smem[];
  const int sld = block_k + 1;
  float* qs = smem;             // qt x (D + 1)
  float* ks = qs + qt * kLd;    // kt x (D + 1)
  float* vs = ks + kt * kLd;    // kt x D
  float* ss = vs + kt * D;      // qt x (block_k + 1)
  float* m_s = ss + qt * sld;   // qt
  float* l_s = m_s + qt;        // qt
  float* a_s = l_s + qt;        // qt: this k-block's rescale factor

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ty = tid / 16, tx = tid % 16;
  const int cy = tid / G::kCw, cx = tid % G::kCw;
  const long long qbase = static_cast<long long>(blockIdx.x) * lq * D;
  const long long kbase = static_cast<long long>(blockIdx.x) * lk * D;
  const int off = lk - lq;
  const int nk = lk / block_k;
  const int q_first = blockIdx.y * block_q;

  for (int r0 = 0; r0 < block_q; r0 += qt) {
    const int rows = min(qt, block_q - r0);
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      qs[r * kLd + d] =
          to_f32(q[qbase + static_cast<long long>(q_first + r0 + r) * D + d]);
    }
    for (int r = tid; r < rows; r += kThreads) {
      m_s[r] = kNegInf;
      l_s[r] = 0.0f;
    }
    float acc[G::kRpt][4];
#pragma unroll
    for (int i = 0; i < G::kRpt; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    __syncthreads();

    for (int ki = 0; ki < nk; ++ki) {
      // the TPU kernel's live test, on the whole (block_q, block_k) tile
      bool live = true;
      if (causal) live = live && (ki * block_k <= q_first + off + block_q - 1);
      if (window >= 0)
        live = live && ((ki + 1) * block_k - 1 > q_first + off - window);
      if (!live) continue;
      const int k0 = ki * block_k;

      // scores of the whole span, kt keys at a time
      for (int j0 = 0; j0 < block_k; j0 += kt) {
        const int keys = min(kt, block_k - j0);
        for (int i = tid; i < keys * D; i += kThreads) {
          const int j = i / D, d = i - j * D;
          ks[j * kLd + d] =
              to_f32(k[kbase + static_cast<long long>(k0 + j0 + j) * D + d]);
        }
        __syncthreads();
        int qrow[4], krow[G::kKb];
#pragma unroll
        for (int a = 0; a < 4; ++a) qrow[a] = min(ty + 16 * a, rows - 1) * kLd;
#pragma unroll
        for (int b = 0; b < G::kKb; ++b)
          krow[b] = min(tx + 16 * b, keys - 1) * kLd;
        float s[4][G::kKb];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < G::kKb; ++b) s[a][b] = 0.0f;
        for (int d = 0; d < D; ++d) {
          float qa[4], kb[G::kKb];
#pragma unroll
          for (int a = 0; a < 4; ++a) qa[a] = qs[qrow[a] + d];
#pragma unroll
          for (int b = 0; b < G::kKb; ++b) kb[b] = ks[krow[b] + d];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < G::kKb; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = ty + 16 * a;
          if (r >= rows) continue;
          const int q_pos = q_first + r0 + r + off;
#pragma unroll
          for (int b = 0; b < G::kKb; ++b) {
            const int j = tx + 16 * b;
            if (j >= keys) continue;
            const int k_pos = k0 + j0 + j;
            bool keep = true;
            if (causal) keep = keep && q_pos >= k_pos;
            if (window >= 0) keep = keep && k_pos > q_pos - window;
            ss[r * sld + j0 + j] = keep ? s[a][b] * scale : kNegInf;
          }
        }
        __syncthreads();  // every read of ks before the next sub-tile
      }

      // per row: m_new, p = exp(s - m_new), l, alpha (one warp per row)
      for (int r = warp; r < rows; r += kThreads / 32) {
        float* srow = ss + r * sld;
        float mx = kNegInf;
        for (int j = lane; j < block_k; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
        for (int w = 16; w > 0; w /= 2)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.0f;
        for (int j = lane; j < block_k; j += 32) {
          const float p = expf(srow[j] - m_new);
          srow[j] = p;
          sum += p;
        }
#pragma unroll
        for (int w = 16; w > 0; w /= 2)
          sum += __shfl_xor_sync(0xffffffffu, sum, w);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
          a_s[r] = alpha;
        }
      }
      __syncthreads();

      // p . v over the span, kt keys at a time
      float pv[G::kRpt][4];
#pragma unroll
      for (int i = 0; i < G::kRpt; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv[i][c] = 0.0f;
      for (int j0 = 0; j0 < block_k; j0 += kt) {
        const int keys = min(kt, block_k - j0);
        for (int i = tid; i < keys * D; i += kThreads) {
          const int j = i / D, d = i - j * D;
          vs[j * D + d] =
              to_f32(v[kbase + static_cast<long long>(k0 + j0 + j) * D + d]);
        }
        __syncthreads();
        for (int j = 0; j < keys; ++j) {
          float vv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) vv[c] = vs[j * D + cx + G::kCw * c];
#pragma unroll
          for (int i = 0; i < G::kRpt; ++i) {
            const int r = cy + G::kTy * i;
            if (r < rows) {
              const float p = ss[r * sld + j0 + j];
#pragma unroll
              for (int c = 0; c < 4; ++c) pv[i][c] = fmaf(p, vv[c], pv[i][c]);
            }
          }
        }
        __syncthreads();  // every read of vs before the next sub-tile
      }
#pragma unroll
      for (int i = 0; i < G::kRpt; ++i) {
        const int r = cy + G::kTy * i;
        if (r < rows) {
          const float alpha = a_s[r];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][c] = acc[i][c] * alpha + pv[i][c];
        }
      }
    }

#pragma unroll
    for (int i = 0; i < G::kRpt; ++i) {
      const int r = cy + G::kTy * i;
      if (r >= rows) continue;
      const float denom = fmaxf(l_s[r], 1e-30f);
      T* orow = o + qbase + static_cast<long long>(q_first + r0 + r) * D;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        from_f32(&orow[cx + G::kCw * c], acc[i][c] / denom);
    }
    __syncthreads();  // before the next sub-tile replaces qs, m and l
  }
}

// (qt, kt) and the dynamic shared memory of one block, as
// core/space.py flash_tiles / flash_smem_bytes compute them.
size_t flash_geometry(int block_q, int block_k, int d, int* qt, int* kt) {
  int rows = kScoreFloats / block_k;
  if (rows > kQtMax) rows = kQtMax;
  if (rows > block_q) rows = block_q;
  if (rows < 1) rows = 1;
  *qt = rows;
  const int kt_max = d <= 128 ? 64 : 32;
  *kt = block_k < kt_max ? block_k : kt_max;
  const size_t floats = static_cast<size_t>(*qt) * (d + 1) +
                        static_cast<size_t>(*kt) * (d + 1) +
                        static_cast<size_t>(*kt) * d +
                        static_cast<size_t>(*qt) * (block_k + 1) + 3 * *qt;
  return sizeof(float) * floats;
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* o,
                         long long bh, int lq, int lk, int block_q,
                         int block_k, int causal, int window, float scale,
                         cudaStream_t stream) {
  int qt, kt;
  const size_t smem = flash_geometry(block_q, block_k, D, &qt, &kt);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = flash_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>(lq / block_q));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lq, lk, block_q, block_k,
      qt, kt, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(int d, const void* q, const void* k, const void* v,
                           void* o, long long bh, int lq, int lk, int block_q,
                           int block_k, int causal, int window, float scale,
                           cudaStream_t stream) {
  switch (d) {
    case 16: return launch_flash<T, 16>(q, k, v, o, bh, lq, lk, block_q, block_k, causal, window, scale, stream);
    case 64: return launch_flash<T, 64>(q, k, v, o, bh, lq, lk, block_q, block_k, causal, window, scale, stream);
    case 128: return launch_flash<T, 128>(q, k, v, o, bh, lq, lk, block_q, block_k, causal, window, scale, stream);
    case 256: return launch_flash<T, 256>(q, k, v, o, bh, lq, lk, block_q, block_k, causal, window, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int kWgConsumers = 256;               // two warpgroups of 64 rows
constexpr int kWgThreads = kWgConsumers + 128;  // + one producer warpgroup
// registers a thread after the producer gives its up (ptxas allots 168 to
// each of the three warpgroups; O alone takes 128 at head dim 256)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTileQ = 128;                     // query rows a tile

// the tile geometry per head dim (core/space.py flash_wgmma_geometry)
template <int D>
struct Wg {
  static constexpr int kDP = D < 64 ? 64 : D;  // head dim in shared memory
  static constexpr int kChunks = kDP / 64;     // 64-wide swizzle chunks
  static constexpr int kKT = kDP == 64 ? 128 : 64;  // keys a step
  static constexpr int kStages = kDP == 256 ? 2 : 3;
  static constexpr int kQChunk = kTileQ * 128;      // bytes
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVChunk = kKT * 128;
  static constexpr int kKVBytes = kChunks * kKVChunk;
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + (3 * kStages + 2) * 8;
};

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_addr(p) & 1023)) & 1023);
}

// S (64 x kKT) += Q (64 x 16) . K^T (16 x kKT) for one k16 step of the
// head dim
template <int kKT>
__device__ __forceinline__ void qk_step(float (&s)[kKT / 2], uint64_t da,
                                        uint64_t db, int accumulate) {
  if constexpr (kKT == 128)
    sm90::wgmma_m64n128k16_ss<0>(s, da, db, accumulate);
  else
    sm90::wgmma_m64n64k16_ss<0>(s, da, db, accumulate);
}

// O (64 x kDP) += P (64 x 16 keys, registers) . V (16 x kDP)
template <int kDP>
__device__ __forceinline__ void pv_step(float (&o)[kDP / 2],
                                        const uint32_t (&a)[4], uint64_t db) {
  if constexpr (kDP == 256)
    sm90::wgmma_m64n256k16_rs<1>(o, a, db, 1);
  else if constexpr (kDP == 128)
    sm90::wgmma_m64n128k16_rs<1>(o, a, db, 1);
  else
    sm90::wgmma_m64n64k16_rs<1>(o, a, db, 1);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (ex2.approx, relative error ~2^-22)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int lq, int lk,
                       int block_q, int block_k, int causal, int window,
                       float scale) {
  using G = Wg<D>;
  constexpr int kKT = G::kKT, kDP = G::kDP, kStages = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = align_1024(smem_raw);
  uint8_t* sk = sq + G::kQBytes;
  uint8_t* sv = sk + kStages * G::kKVBytes;
  uint64_t* kfull = reinterpret_cast<uint64_t*>(sv + kStages * G::kKVBytes);
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;
  uint64_t* qfull = empty + kStages;
  uint64_t* qempty = qfull + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&kfull[s], 1);
      sm90::mbar_init(&vfull[s], 1);
      sm90::mbar_init(&empty[s], kWgConsumers);
    }
    sm90::mbar_init(qfull, 1);
    sm90::mbar_init(qempty, kWgConsumers);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int bh = blockIdx.x;
  const int off = lk - lq;
  // the last query blocks first: under a causal mask they see the most
  // keys, and the card starts blocks in order, so the long ones do not
  // trail the wave
  const int q_first = (gridDim.y - 1 - blockIdx.y) * block_q;
  // the TPU kernel's live test on each (block_q, block_k) tile: causal
  // keeps a prefix of the k-blocks, the window a suffix, so the live ones
  // form one run [lo, hi]
  int lo = lk / block_k, hi = -1;
  for (int ki = 0; ki < lk / block_k; ++ki) {
    bool live = true;
    if (causal) live = live && (ki * block_k <= q_first + off + block_q - 1);
    if (window >= 0)
      live = live && ((ki + 1) * block_k - 1 > q_first + off - window);
    if (live) {
      lo = min(lo, ki);
      hi = ki;
    }
  }
  const int k_start = lo * block_k, k_end = (hi + 1) * block_k;
  const int n_steps = hi < lo ? 0 : (k_end - k_start + kKT - 1) / kKT;
  const int n_tiles = (block_q + kTileQ - 1) / kTileQ;

  if (tid >= kWgConsumers) {  // the producer: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid != kWgConsumers) return;
    int it = 0;
    for (int t = 0; t < n_tiles; ++t) {
      sm90::mbar_wait(qempty, (t & 1) ^ 1);
      sm90::mbar_expect_tx(qfull, G::kQBytes);
      for (int c = 0; c < G::kChunks; ++c)
        sm90::tma_load_3d(sq + c * G::kQChunk, &qmap, qfull, c * 64,
                          q_first + t * kTileQ, bh);
      for (int s = 0; s < n_steps; ++s, ++it) {
        const int slot = it % kStages;
        const int k0 = k_start + s * kKT;
        sm90::mbar_wait(&empty[slot], ((it / kStages) & 1) ^ 1);
        sm90::mbar_expect_tx(&kfull[slot], G::kKVBytes);
        for (int c = 0; c < G::kChunks; ++c)
          sm90::tma_load_3d(sk + slot * G::kKVBytes + c * G::kKVChunk, &kmap,
                            &kfull[slot], c * 64, k0, bh);
        sm90::mbar_expect_tx(&vfull[slot], G::kKVBytes);
        for (int c = 0; c < G::kChunks; ++c)
          sm90::tma_load_3d(sv + slot * G::kKVBytes + c * G::kKVChunk, &vmap,
                            &vfull[slot], c * 64, k0, bh);
      }
    }
  } else {  // the consumers, until the end of the kernel
    sm90::setmaxnreg_inc<kConsumerRegs>();
    // accumulator fragments: element i of a thread sits in tile row
    // row + 8 ((i / 2) % 2) and column 8 (i / 4) + col + i % 2
    const int wg = tid / 128;
    const int row = wg * 64 + (tid % 128) / 32 * 16 + (tid % 32) / 4;
    const int col = 2 * (tid % 4);
    int it = 0;
    for (int t = 0; t < n_tiles; ++t) {
      sm90::mbar_wait(qfull, t & 1);
      const int q_pos = q_first + t * kTileQ + row + off;  // + 8 for half 1
      float acc[kDP / 2];
#pragma unroll
      for (int i = 0; i < kDP / 2; ++i) acc[i] = 0.0f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
      for (int s = 0; s < n_steps; ++s, ++it) {
        const int slot = it % kStages;
        const uint32_t parity = (it / kStages) & 1;
        const int k0 = k_start + s * kKT;
        const uint8_t* ks = sk + slot * G::kKVBytes;
        const uint8_t* vs = sv + slot * G::kKVBytes;

        float sc[kKT / 2];
        sm90::mbar_wait(&kfull[slot], parity);
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kDP / 16; ++j) {
          const uint64_t da = sm90::desc_sw128(
              sq + j / 4 * G::kQChunk + wg * 64 * 128 + j % 4 * 32, 16, 1024);
          const uint64_t db = sm90::desc_sw128(
              ks + j / 4 * G::kKVChunk + j % 4 * 32, 16, 1024);
          qk_step<kKT>(sc, da, db, j > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(sc);
        if (s == n_steps - 1) sm90::mbar_arrive(qempty);

        // scale and masks; keys past the live run score -inf.  A step
        // whose keys every row of the tile sees needs no mask.
        const int q_lo = q_first + t * kTileQ + off;
        const bool masked =
            k0 + kKT > k_end || (causal && k0 + kKT - 1 > q_lo) ||
            (window >= 0 && k0 <= q_lo + kTileQ - 1 - window);
        float mx[2] = {-INFINITY, -INFINITY};
        if (masked) {
#pragma unroll
          for (int i = 0; i < kKT / 2; ++i) {
            const int h = (i / 2) % 2;
            const int k_pos = k0 + 8 * (i / 4) + col + i % 2;
            const int qp = q_pos + 8 * h;
            float v = -INFINITY;
            if (k_pos < k_end) {
              bool keep = true;
              if (causal) keep = keep && qp >= k_pos;
              if (window >= 0) keep = keep && k_pos > qp - window;
              v = keep ? sc[i] * scale : kNegInf;
            }
            sc[i] = v;
            mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], v);
          }
        } else {
#pragma unroll
          for (int i = 0; i < kKT / 2; ++i) {
            sc[i] *= scale;
            mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
          }
        }
        // exp(x) as 2^(x log2 e) by the hardware's exp2; the difference is
        // taken first, so a -1e30 score at m = -1e30 still gives p = 1
        float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_new = fmaxf(m[h], quad_max(mx[h]));
          alpha[h] = fast_exp2((m[h] - m_new) * kLog2e);
          m[h] = m_new;
        }
#pragma unroll
        for (int i = 0; i < kKT / 2; ++i) {
          sc[i] = fast_exp2((sc[i] - m[(i / 2) % 2]) * kLog2e);
          sum[(i / 2) % 2] += sc[i];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(sum[h]);
#pragma unroll
        for (int i = 0; i < kDP / 2; ++i) acc[i] *= alpha[(i / 2) % 2];

        // P in bf16 as the A operand: keys 16 c ... 16 c + 15
        uint32_t pa[kKT / 16][4];
#pragma unroll
        for (int c = 0; c < kKT / 16; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pa[c][e] =
                sm90::pack_bf16(sc[8 * c + 2 * e], sc[8 * c + 2 * e + 1]);
        sm90::mbar_wait(&vfull[slot], parity);
        sm90::wgmma_fence();
#pragma unroll
        for (int c = 0; c < kKT / 16; ++c)
          pv_step<kDP>(acc, pa[c],
                       sm90::desc_sw128(vs + c * 16 * 128, G::kKVChunk, 1024));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        sm90::mbar_arrive(&empty[slot]);
      }
      if (n_steps == 0) sm90::mbar_arrive(qempty);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = t * kTileQ + row + 8 * h;
        if (r >= block_q) continue;
        const float denom = fmaxf(l[h], 1e-30f);
        __nv_bfloat16* orow =
            o + (static_cast<long long>(bh) * lq + q_first + r) * D;
#pragma unroll
        for (int i = 2 * h; i < kDP / 2; i += 4) {
          const int cc = 8 * (i / 4) + col;
          if (cc < D)
            *reinterpret_cast<__nv_bfloat162*>(orow + cc) =
                __floats2bfloat162_rn(acc[i] / denom, acc[i + 1] / denom);
        }
      }
    }
  }
}

template <int D>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                       long long bh, int lq, int lk, int block_q, int block_k,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  using G = Wg<D>;
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {D, static_cast<uint64_t>(lq),
                             static_cast<uint64_t>(bh)};
  const uint64_t kdims[3] = {D, static_cast<uint64_t>(lk),
                             static_cast<uint64_t>(bh)};
  const uint32_t qbox[3] = {64, kTileQ, 1};
  const uint32_t kbox[3] = {64, G::kKT, 1};
  int code = sm90::make_map_bf16(&qmap, q, 3, qdims, qbox);
  if (code == 0) code = sm90::make_map_bf16(&kmap, k, 3, kdims, kbox);
  if (code == 0) code = sm90::make_map_bf16(&vmap, v, 3, kdims, kbox);
  if (code != 0) return code;
  auto kernel = flash_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(G::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>(lq / block_q));
  kernel<<<grid, kWgThreads, G::kSmem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), lq, lk, block_q,
      block_k, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, o: (bh, lq, d); k, v: (bh, lk, d),
// contiguous on the device; lq % block_q == 0, lk % block_k == 0,
// d in {16, 64, 128, 256}.  window < 0: no local window.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int dtype, long long bh, int lq, int lk,
                          int d, int block_q, int block_k, int causal,
                          int window, float scale, void* stream) {
  if (bh < 1 || lq < 1 || lk < 1 || block_q < 1 || block_k < 1 ||
      lq % block_q || lk % block_k || lq / block_q > 65535)
    return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_flash<float>(d, q, k, v, o, bh, lq, lk, block_q, block_k,
                                 causal, window, scale, strm);
  if (dtype == 1)
    return dispatch_flash<__nv_bfloat16>(d, q, k, v, o, bh, lq, lk, block_q,
                                         block_k, causal, window, scale, strm);
  return cudaErrorInvalidValue;
}

// bf16 on the tensor cores.  q, o: (bh, lq, d); k, v: (bh, lk, d),
// contiguous on the device; lq % block_q == 0, lk % block_k == 0,
// d in {16, 64, 128, 256}.  window < 0: no local window.
int repro_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                void* o, long long bh, int lq, int lk, int d,
                                int block_q, int block_k, int causal,
                                int window, float scale, void* stream) {
  if (bh < 1 || lq < 1 || lk < 1 || block_q < 1 || block_k < 1 ||
      lq % block_q || lk % block_k || lq / block_q > 65535)
    return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_flash_wgmma<16>(q, k, v, o, bh, lq, lk, block_q, block_k, causal, window, scale, strm);
    case 64: return launch_flash_wgmma<64>(q, k, v, o, bh, lq, lk, block_q, block_k, causal, window, scale, strm);
    case 128: return launch_flash_wgmma<128>(q, k, v, o, bh, lq, lk, block_q, block_k, causal, window, scale, strm);
    case 256: return launch_flash_wgmma<256>(q, k, v, o, bh, lq, lk, block_q, block_k, causal, window, scale, strm);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
