// Hand-written Hopper kernel for flash attention.
//
//   repro_flash_attention  replaces repro/kernels/attention/kernel.py
//                          flash_attention_pallas (_flash_kernel).
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py).  The
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or the error of the call that failed first).
//
// What it computes.  Online-softmax attention over flattened rows: q
// (BH, Lq, D), k and v (BH, Lk, D), f32 or bf16 in, out in q's type, with
// f32 scores, running max m, denominator l and accumulator acc.  Causal
// and local-window masks come from global positions, the queries sitting
// in the last Lq slots of the key stream (offset Lk - Lq).  It is the TPU
// kernel's function, step for step:
//   * the TPU grid (BH, Lq / block_q, Lk / block_k) with a sequential k
//     axis becomes the CUDA grid (BH, Lq / block_q) and a loop over the
//     k-blocks inside the block, because a CUDA grid has no order;
//   * a k-block is skipped when the TPU kernel's `live` test says its
//     whole (block_q, block_k) score tile is masked;
//   * per live k-block: s = (q . k) * scale in f32, masked entries set to
//     -1e30 (not -inf: a row whose first live block masks all of its keys
//     then gets p = 1 and is wiped by the next rescale, as on the TPU, where
//     -inf would give exp(-inf + inf) = NaN), m_new = max(m, rowmax s),
//     p = exp(s - m_new), alpha = exp(m - m_new), l = l * alpha + sum p,
//     acc = acc * alpha + p . v;
//   * out = acc / max(l, 1e-30).
// block_k sets how many keys one rescale covers, block_q how many query
// rows a block owns.  A block works on its block_q rows qt at a time
// (qt = min(block_q, 64, 16384 / block_k): the whole block_k span of
// scores for qt rows is held in shared memory, so the row max is known
// before any p is formed) and stages K and V in sub-tiles of kt keys (64,
// or 32 at head_dim 256).  The footprint is core/space.py
// flash_smem_bytes, which is what the h100 attention space admits by.
//
// What bounds it on the card: operations (4 D flops per live (query, key)
// pair; at Lq = Lk = 2048 and D = 64 the pairs outweigh the bytes 300
// to 1).  This first kernel runs them on the CUDA cores in f32 with
// register micro-tiles (4 x 4 scores, 4 output dims x up to 16 rows a
// thread) over shared memory; the tensor cores (wgmma) with TMA staging
// and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // extern "C"
