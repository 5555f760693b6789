// Hand-written Hopper kernel for the tiled matrix product.
//
//   repro_matmul  replaces repro/kernels/matmul/kernel.py matmul_pallas
//                 (_matmul_kernel).
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py).  The
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or the error of the call that failed first).
//
// What it computes.  c = a @ b for row-major a (M, K) and b (K, N), f32 or
// bf16 in, the product in the input type, accumulated in f32.  It is the
// TPU kernel's function in its order:
//   * the TPU grid (M / block_m, N / block_n, K / block_k) with the K axis
//     sequential becomes the CUDA grid (N / block_n, M / block_m) and a
//     loop over the K / block_k k-blocks inside the block;
//   * per k-block the partial product of the block_k terms is formed on
//     its own, then added to the f32 accumulator (acc += a_blk @ b_blk, as
//     the TPU kernel adds each k-block's dot to its VMEM scratch);
//   * the output block is written once, in the input type.
// A block owns the plan's (block_m, block_n) output tile and walks it in
// 64 x 64 sub-tiles (each thread a 4 x 4 register micro-tile), staging a
// 32-deep slab of a (K-major, rows padded by one float) and of b in shared
// memory per step: 16.5 KB whatever the blocks, so the h100 matmul space
// admits every config.
//
// What bounds it on the card: operations (2 M N K; at qwen's MLP shape,
// (8192, 1024) @ (1024, 2816), some 900 flops per byte moved).  This
// first kernel runs them on the CUDA cores in f32; the tensor cores
// (wgmma) with TMA staging are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // extern "C"
