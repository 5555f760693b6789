// Hand-written Hopper kernels for the tiled matrix product.
//
//   repro_matmul_wgmma  (bf16, the tensor cores) and
//   repro_matmul        (f32, the CUDA cores) replace
//                       repro/kernels/matmul/kernel.py matmul_pallas
//                       (_matmul_kernel).
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py).  The
// entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() (or the error of the call that failed first).
//
// What they compute.  c = a @ b for row-major a (M, K) and b (K, N), the
// product in the input type, accumulated in f32.  It is the TPU kernel's
// function in its order:
//   * the TPU grid (M / block_m, N / block_n, K / block_k) with the K axis
//     sequential becomes the CUDA grid (N / block_n, M / block_m) and a
//     loop over the K / block_k k-blocks inside the block;
//   * per k-block the partial product of the block_k terms is formed on
//     its own, then added to the f32 accumulator (acc += a_blk @ b_blk, as
//     the TPU kernel adds each k-block's dot to its VMEM scratch);
//   * the output block is written once, in the input type.
//
// What bounds it on the card: operations (2 M N K; at qwen's MLP shape,
// (8192, 1024) @ (1024, 2816), some 900 flops per byte moved).
//
// The bf16 kernel runs them on the tensor cores.  A block walks its
// (block_m, block_n) output block in 128 x 128 tiles: two consumer
// warpgroups of 64 rows, each holding 64 f32 registers of accumulator and
// 64 of k-block partial a thread, and one producer warp that streams A
// (K-major) and B (row-major (K, N): MN-major, the transpose bit) by TMA
// with a 128-byte swizzle, 64 deep a stage, through a ring of kStages
// shared-memory stages behind full / empty mbarriers, so loads run ahead
// of the products.  wgmma m64n128k16 forms the partial; at each block_k
// boundary the partial is added to the accumulator and restarted
// (scale-d 0): after the k-block's last products where block_k is whole
// stages, inside a stage otherwise.  TMA zero-fills the ragged edge (M, N or K short of a
// tile); the store masks rows and columns outside the block.  The
// footprint is fixed (kSmemBytes, 129 KB), whatever the blocks, so the
// h100 matmul space admits every config.  It takes block_k a multiple of
// 16 (a k-block is whole k16 steps) and N a multiple of 8 (TMA's 16-byte
// row pitch); the wrapper (kernels/matmul/kernel.py matmul_route) sends
// every other bf16 shape to the CUDA-core kernel below, before launch.
//
// The f32 kernel (TF32 would lose f32's accuracy, so it stays off the
// tensor cores) walks the block in 64 x 64 sub-tiles (each thread a 4 x 4
// register micro-tile), staging a 32-deep slab of a (K-major, rows padded
// by one float) and of b in shared memory per step: 16.5 KB whatever the
// blocks.  It also takes bf16 (converted to f32 on load): the "ragged"
// route, for bf16 shapes the tensor-core kernel does not take (K or N off
// TMA's 16-byte pitch, block_k not whole k16 steps), and the record of the
// earlier design beside the tensor-core kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // sub-tile edge: 16 x 16 threads, 4 x 4 each
constexpr int kKc = 32;    // K depth staged per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, int M, int N, int K, int block_m,
                  int block_n, int block_k) {
  __shared__ float as[kKc][kTile + 1];
  __shared__ float bs[kKc][kTile];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int kc = block_k < kKc ? block_k : kKc;
  const long long m_block = static_cast<long long>(blockIdx.y) * block_m;
  const long long n_block = static_cast<long long>(blockIdx.x) * block_n;

  for (int mt = 0; mt < block_m; mt += kTile) {
    for (int nt = 0; nt < block_n; nt += kTile) {
      const int rows = min(kTile, block_m - mt);
      const int cols = min(kTile, block_n - nt);
      const long long m0 = m_block + mt;
      const long long n0 = n_block + nt;
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

      for (int k0 = 0; k0 < K; k0 += block_k) {
        float part[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[i][j] = 0.0f;
        for (int kk = 0; kk < block_k; kk += kc) {
          const int depth = min(kc, block_k - kk);
          const long long kbase = static_cast<long long>(k0) + kk;
          for (int i = tid; i < kTile * kc; i += kThreads) {
            const int r = i / kc, kq = i - (i / kc) * kc;
            as[kq][r] = (r < rows && kq < depth)
                            ? to_f32(a[(m0 + r) * K + kbase + kq])
                            : 0.0f;
          }
          for (int i = tid; i < kc * kTile; i += kThreads) {
            const int kq = i / kTile, col = i - (i / kTile) * kTile;
            bs[kq][col] = (col < cols && kq < depth)
                              ? to_f32(b[(kbase + kq) * N + n0 + col])
                              : 0.0f;
          }
          __syncthreads();
          for (int kq = 0; kq < depth; ++kq) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) av[i] = as[kq][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = bs[kq][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                part[i][j] = fmaf(av[i], bv[j], part[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          if (col < cols) from_f32(&c[(m0 + r) * N + n0 + col], acc[i][j]);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_matmul(const void* a, const void* b, void* c, int M, int N,
                          int K, int block_m, int block_n, int block_k,
                          cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(N / block_n),
                  static_cast<unsigned>(M / block_m));
  matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K, block_m, block_n, block_k);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores ----------------------------------------------

constexpr int kBM = 128;            // tile rows: two warpgroups of 64
constexpr int kBN = 128;            // tile columns: two 64-wide B chunks
constexpr int kBK = 64;             // k depth of a stage (one swizzle row)
constexpr int kStages = 4;          // shared-memory ring
constexpr int kConsumers = 256;     // two consumer warpgroups
constexpr int kWgThreads = kConsumers + 32;  // + one producer warp
constexpr int kATile = kBM * kBK * 2;        // 16 KB: 128 rows x 64 k
constexpr int kBChunk = kBK * 64 * 2;        // 8 KB: 64 k rows x 64 n
constexpr int kStageBytes = kATile + 2 * kBChunk;
constexpr size_t kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_addr(p) & 1023)) & 1023);
}

// kWholeStages: block_k a multiple of the stage depth, so each k-block is
// whole stages and its partial is folded after all its products are done;
// otherwise a fold may fall inside a stage (correct, but ptxas then
// serialises the products)
template <bool kWholeStages>
__global__ void __launch_bounds__(kWgThreads, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap,
                        __nv_bfloat16* __restrict__ c, int N, int K,
                        int block_m, int block_n, int block_k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int tiles_n = (block_n + kBN - 1) / kBN;
  const int n_tiles = (block_m + kBM - 1) / kBM * tiles_n;
  const int n_k = (K + kBK - 1) / kBK;
  const int m_block = blockIdx.y * block_m;
  const int n_block = blockIdx.x * block_n;

  if (tid >= kConsumers) {  // the producer warp: one thread issues TMA
    if (tid != kConsumers) return;
    int it = 0;
    for (int t = 0; t < n_tiles; ++t) {
      const int m0 = m_block + t / tiles_n * kBM;
      const int n0 = n_block + t % tiles_n * kBN;
      for (int s = 0; s < n_k; ++s, ++it) {
        const int slot = it % kStages;
        sm90::mbar_wait(&empty[slot], ((it / kStages) & 1) ^ 1);
        uint8_t* st = tiles + slot * kStageBytes;
        sm90::mbar_expect_tx(&full[slot], kStageBytes);
        sm90::tma_load_2d(st, &amap, &full[slot], s * kBK, m0);
        sm90::tma_load_2d(st + kATile, &bmap, &full[slot], n0, s * kBK);
        sm90::tma_load_2d(st + kATile + kBChunk, &bmap, &full[slot], n0 + 64,
                          s * kBK);
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int row = wg * 64 + (tid % 128) / 32 * 16 + (tid % 32) / 4;
  const int col = 2 * (tid % 4);
  int it = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int tm = t / tiles_n * kBM, tn = t % tiles_n * kBN;
    float acc[64], part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
    if constexpr (kWholeStages) {
      for (int kb = 0; kb < K / block_k; ++kb) {
        int prev = -1;  // the slot whose products may still be in flight
        for (int sb = 0; sb < block_k / kBK; ++sb, ++it) {
          const int slot = it % kStages;
          sm90::mbar_wait(&full[slot], (it / kStages) & 1);
          const uint8_t* st = tiles + slot * kStageBytes;
          const uint64_t da = sm90::desc_sw128(st + wg * 64 * 128, 16, 1024);
          const uint64_t db = sm90::desc_sw128(st + kATile, kBChunk, 1024);
          sm90::wgmma_fence();
#pragma unroll
          for (int j = 0; j < kBK / 16; ++j)
            sm90::wgmma_m64n128k16_ss<1>(part, da + 2 * j, db + 128 * j,
                                         sb > 0 || j > 0);
          sm90::wgmma_commit();
          sm90::wgmma_wait<1>();  // all but this stage's products are done
          if (prev >= 0) sm90::mbar_arrive(&empty[prev]);
          prev = slot;
        }
        sm90::wgmma_wait<0>();
        sm90::fence_regs(part);
        sm90::mbar_arrive(&empty[prev]);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
    } else {
      int prev = -1;
      for (int s = 0; s < n_k; ++s, ++it) {
        const int slot = it % kStages;
        sm90::mbar_wait(&full[slot], (it / kStages) & 1);
        const uint8_t* st = tiles + slot * kStageBytes;
        const uint64_t da = sm90::desc_sw128(st + wg * 64 * 128, 16, 1024);
        const uint64_t db = sm90::desc_sw128(st + kATile, kBChunk, 1024);
        sm90::wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBK / 16; ++j) {
          const int kk = s * kBK + j * 16;
          if (kk >= K) break;
          int accumulate = 1;
          if (kk % block_k == 0) {  // a new k-block: fold the last partial
            accumulate = 0;
            if (kk > 0) {
              sm90::wgmma_commit();
              sm90::wgmma_wait<0>();
              sm90::fence_regs(part);
#pragma unroll
              for (int i = 0; i < 64; ++i) acc[i] += part[i];
              sm90::fence_regs(part);
              sm90::wgmma_fence();
            }
          }
          sm90::wgmma_m64n128k16_ss<1>(part, da + 2 * j, db + 128 * j,
                                       accumulate);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();
        if (prev >= 0) sm90::mbar_arrive(&empty[prev]);
        prev = slot;
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(part);
      if (prev >= 0) sm90::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }

    // rows row and row + 8, columns 8 j + col and + 1 of the tile
    const int rows_left = block_m - tm, cols_left = block_n - tn;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = row + 8 * ((i / 2) % 2);
      const int cc = 8 * (i / 4) + col;
      if (r >= rows_left || cc >= cols_left) continue;
      __nv_bfloat16* dst =
          c + static_cast<long long>(m_block + tm + r) * N + n_block + tn + cc;
      if (cc + 1 < cols_left)
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      else
        *dst = __float2bfloat16_rn(acc[i]);
    }
  }
}

cudaError_t launch_matmul_wgmma(const void* a, const void* b, void* c, int M,
                                int N, int K, int block_m, int block_n,
                                int block_k, cudaStream_t stream, int* code) {
  CUtensorMap amap, bmap;
  const uint64_t adims[2] = {static_cast<uint64_t>(K),
                             static_cast<uint64_t>(M)};
  const uint32_t abox[2] = {kBK, kBM};
  const uint64_t bdims[2] = {static_cast<uint64_t>(N),
                             static_cast<uint64_t>(K)};
  const uint32_t bbox[2] = {64, kBK};
  *code = sm90::make_map_bf16(&amap, a, 2, adims, abox);
  if (*code == 0) *code = sm90::make_map_bf16(&bmap, b, 2, bdims, bbox);
  if (*code != 0) return cudaSuccess;
  auto kernel = block_k % kBK == 0 ? matmul_wgmma_kernel<true>
                                    : matmul_wgmma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(N / block_n),
                  static_cast<unsigned>(M / block_m));
  kernel<<<grid, kWgThreads, kSmemBytes, stream>>>(
      amap, bmap, static_cast<__nv_bfloat16*>(c), N, K, block_m, block_n,
      block_k);
  return cudaGetLastError();
}

// One product of a 64 x 64 bf16 tile a (K-major) with b, either K-major
// (n x 64, the B of a . b^T) or MN-major (64 x n, the transpose bit), over
// the first 16 ksteps columns of a: the descriptors and layouts the
// kernels use, held against torch.matmul by the card tests.
template <int kN, int kTransB>
__global__ void __launch_bounds__(128)
    wgmma_probe_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap,
                       float* __restrict__ c, int ksteps) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa = align_1024(smem_raw);
  uint8_t* sb = sa + 64 * 128;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sb + kN * 128);
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar, 64 * 128 + kN * 128);
    sm90::tma_load_2d(sa, &amap, bar, 0, 0);
    if (kTransB)
      for (int ch = 0; ch < kN / 64; ++ch)
        sm90::tma_load_2d(sb + ch * 8192, &bmap, bar, ch * 64, 0);
    else
      sm90::tma_load_2d(sb, &bmap, bar, 0, 0);
  }
  sm90::mbar_wait(bar, 0);
  float d[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) d[i] = 0.0f;
  const uint64_t da = sm90::desc_sw128(sa, 16, 1024);
  // MN-major: B's 64-wide column chunks lie 8 KB apart
  const uint64_t db = sm90::desc_sw128(sb, kTransB ? 8192 : 16, 1024);
  sm90::wgmma_fence();
  for (int j = 0; j < ksteps; ++j) {
    const uint64_t dbj = db + (kTransB ? 128 * j : 2 * j);
    if constexpr (kN == 64)
      sm90::wgmma_m64n64k16_ss<kTransB>(d, da + 2 * j, dbj, j > 0);
    else
      sm90::wgmma_m64n128k16_ss<kTransB>(d, da + 2 * j, dbj, j > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(d);
  const int row = (tid / 32) * 16 + (tid % 32) / 4, col = 2 * (tid % 4);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i)
    c[(row + 8 * ((i / 2) % 2)) * kN + 8 * (i / 4) + col + i % 2] = d[i];
}

template <int kN, int kTransB>
int launch_probe(const void* a, const void* b, void* c, int ksteps,
                 cudaStream_t stream) {
  CUtensorMap amap, bmap;
  const uint64_t adims[2] = {64, 64};
  const uint32_t abox[2] = {64, 64};
  const uint64_t bdims[2] = {kTransB ? static_cast<uint64_t>(kN) : 64,
                             kTransB ? 64 : static_cast<uint64_t>(kN)};
  const uint32_t bbox[2] = {64, kTransB ? 64u : static_cast<uint32_t>(kN)};
  int code = sm90::make_map_bf16(&amap, a, 2, adims, abox);
  if (code == 0) code = sm90::make_map_bf16(&bmap, b, 2, bdims, bbox);
  if (code != 0) return code;
  const size_t smem = 1024 + 64 * 128 + kN * 128 + 8;
  wgmma_probe_kernel<kN, kTransB><<<1, 128, smem, stream>>>(
      amap, bmap, static_cast<float*>(c), ksteps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  a: (M, K), b: (K, N), c: (M, N),
// row-major and contiguous on the device; M % block_m == 0,
// N % block_n == 0, K % block_k == 0.
int repro_matmul(const void* a, const void* b, void* c, int dtype, int M,
                 int N, int K, int block_m, int block_n, int block_k,
                 void* stream) {
  if (M < 1 || N < 1 || K < 1 || block_m < 1 || block_n < 1 ||
      block_k < 1 || M % block_m || N % block_n || K % block_k ||
      M / block_m > 65535)
    return cudaErrorInvalidValue;
  auto strm = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_matmul<float>(a, b, c, M, N, K, block_m, block_n, block_k,
                                strm);
  if (dtype == 1)
    return launch_matmul<__nv_bfloat16>(a, b, c, M, N, K, block_m, block_n,
                                        block_k, strm);
  return cudaErrorInvalidValue;
}

// bf16 on the tensor cores.  a: (M, K), b: (K, N), c: (M, N), row-major
// and contiguous on the device; M % block_m == 0, N % block_n == 0,
// K % block_k == 0, block_k % 16 == 0, N % 8 == 0.
int repro_matmul_wgmma(const void* a, const void* b, void* c, int M, int N,
                       int K, int block_m, int block_n, int block_k,
                       void* stream) {
  if (M < 1 || N < 1 || K < 1 || block_m < 1 || block_n < 1 ||
      block_k < 16 || M % block_m || N % block_n || K % block_k ||
      block_k % 16 || N % 8 || M / block_m > 65535)
    return cudaErrorInvalidValue;
  int code = 0;
  const cudaError_t err =
      launch_matmul_wgmma(a, b, c, M, N, K, block_m, block_n, block_k,
                          static_cast<cudaStream_t>(stream), &code);
  return code != 0 ? code : static_cast<int>(err);
}

// The wgmma probe: c (64, n) f32 = a (64, 64)[:, :16 ksteps] @ b, with b
// (n, 64) K-major (b_mn_major 0: c = a . b^T) or (64, n) MN-major (1);
// n in {64, 128}.
int repro_wgmma_probe(const void* a, const void* b, void* c, int n,
                      int b_mn_major, int ksteps, void* stream) {
  auto strm = static_cast<cudaStream_t>(stream);
  if (ksteps < 1 || ksteps > 4) return cudaErrorInvalidValue;
  if (n == 64 && !b_mn_major)
    return launch_probe<64, 0>(a, b, c, ksteps, strm);
  if (n == 64) return launch_probe<64, 1>(a, b, c, ksteps, strm);
  if (n == 128 && !b_mn_major)
    return launch_probe<128, 0>(a, b, c, ksteps, strm);
  if (n == 128) return launch_probe<128, 1>(a, b, c, ksteps, strm);
  return cudaErrorInvalidValue;
}

}  // extern "C"
