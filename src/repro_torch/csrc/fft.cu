// Hand-written Hopper kernel for the batched complex FFT: self-sorting
// mixed-radix Stockham, each row resident in shared memory.
//
//   repro_fft  replaces repro/kernels/fft/kernel.py fft_pallas.
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py).  The
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (or the error of the call that failed first).
//
// What it computes.  The DFT of each row of a (batch, n) complex64 array,
// in f32, written as complex64 (inverse: the conjugate transform scaled by
// 1/n at the store).  It follows the plan the tuner chose:
//   * one thread block owns `rows` whole rows (the CUDA grid is
//     batch / rows); the rows it holds at once are resident in shared
//     memory;
//   * the plan's stage sequence (stage_radices, mixed radix included) is
//     passed by value.  Stage t views a row as (n_cur, s), s the product of
//     the earlier fan-ins, m = n_cur / rr, and for every (p < m, q < s)
//     reads x[(k m + p) s + q] for k < rr and writes
//       y[(p rr + j) s + q] = exp(i theta_j p) * sum_k x[(k m + p) s + q] w^(j k)
//     for j < rr, with w = exp(-+2 pi i / rr) and theta_j = -+2 pi j / n_cur
//     (+ for the inverse): the rr-point DFT folded over k in order, then the
//     twiddle, the radix digit innermost (self-sorting, no bit reversal);
//   * the first stage reads the input from device memory and the last one
//     writes the output there; the stages between them ping-pong between
//     two shared-memory buffers, one barrier a stage;
//   * fan-ins 2, 4, 8 and 16 are specialised (the rr inputs of a butterfly
//     held in registers, the loops unrolled); any other fan-in (the ragged
//     and prime tails: (8, 6, 2) at n = 96, (2, 53) at n = 106) runs a
//     generic loop that reads its inputs from the buffer;
//   * `unroll` is the least number of butterflies a thread owns per stage
//     (launch geometry only: the TPU kernel does not read the knob, and it
//     changes no result here).
// Rounding.  Every multiply and add is __fmul_rn / __fadd_rn / __fsub_rn
// (no FMA contraction, no fast math), in the order of the plain version
// (primitives.butterfly): the DFT weights w^t are cos/sin in float64
// rounded to f32, as Python computes them; theta_j is rounded to f32, the
// product theta_j * p is taken in f32 and its cos/sin by sincosf (the
// precise libdevice version, which may differ from PyTorch's by an ulp).
// Both tables are built once per block in shared memory.
//
// What bounds it on the card: at the paper's sizes memory bandwidth (16
// bytes an element: one complex64 read, one written), with log_rr(n)
// stages of on-chip work; the rr-point DFT is folded directly (rr complex
// multiply-adds an output, as on the TPU), so radix 16 costs more
// operations than radix 2.  A block that holds rows * n = 8192 points uses
// 128 KiB of shared memory (two complex f32 buffers), above the 48 KB
// default, so the launch raises the block's dynamic shared-memory limit.
// Where a plan's rows * n does not fit (the four-step column launches take
// their rows from the large-N config), the block transforms its rows in
// groups that do.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxStages = 32;
constexpr int kMaxThreads = 512;
constexpr size_t kSmemLimit = 232448;  // shared memory a block may use
constexpr double kPi = 3.141592653589793;

struct FftStages {
  int count;
  int radix[kMaxStages];
};

// Output j of one butterfly: twiddle (j > 0), optional 1/n scale, store.
__device__ __forceinline__ void finish(float tr, float ti, int j, int p,
                                       const float* th, float2* dst,
                                       int idx, bool scale_it, float scale) {
  if (j != 0) {
    float sn, cs;
    sincosf(__fmul_rn(th[j], static_cast<float>(p)), &sn, &cs);
    const float nr = __fsub_rn(__fmul_rn(tr, cs), __fmul_rn(ti, sn));
    const float ni = __fadd_rn(__fmul_rn(tr, sn), __fmul_rn(ti, cs));
    tr = nr;
    ti = ni;
  }
  if (scale_it) {
    tr = __fmul_rn(tr, scale);
    ti = __fmul_rn(ti, scale);
  }
  dst[idx] = make_float2(tr, ti);
}

// tr += x.re w.re - x.im w.im;  ti += x.re w.im + x.im w.re
__device__ __forceinline__ void fold(float& tr, float& ti, float2 x,
                                     float2 w) {
  tr = __fadd_rn(tr, __fsub_rn(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y)));
  ti = __fadd_rn(ti, __fadd_rn(__fmul_rn(x.x, w.y), __fmul_rn(x.y, w.x)));
}

// One radix-R stage over `rows` resident rows (R a compile-time fan-in).
template <int R>
__device__ void stage_fixed(const float2* src, float2* dst, int n, int rows,
                            int n_cur, int s, const float2* w,
                            const float* th, bool scale_it, float scale) {
  const int m = n_cur / R;
  const int per_row = n / R;
  const int total = rows * per_row;
  for (int b = threadIdx.x; b < total; b += blockDim.x) {
    const int row = b / per_row;
    const int rem = b - row * per_row;
    const int p = rem / s;
    const int q = rem - p * s;
    const int base = row * n;
    float2 x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = src[base + (k * m + p) * s + q];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float tr = 0.0f, ti = 0.0f;
#pragma unroll
      for (int k = 0; k < R; ++k) fold(tr, ti, x[k], w[(j * k) % R]);
      finish(tr, ti, j, p, th, dst, base + (p * R + j) * s + q, scale_it,
             scale);
    }
  }
}

// The same stage for any fan-in rr (inputs read from src per output).
__device__ void stage_generic(const float2* src, float2* dst, int n, int rows,
                              int n_cur, int s, int rr, const float2* w,
                              const float* th, bool scale_it, float scale) {
  const int m = n_cur / rr;
  const int per_row = n / rr;
  const int total = rows * per_row;
  for (int b = threadIdx.x; b < total; b += blockDim.x) {
    const int row = b / per_row;
    const int rem = b - row * per_row;
    const int p = rem / s;
    const int q = rem - p * s;
    const int base = row * n;
    for (int j = 0; j < rr; ++j) {
      float tr = 0.0f, ti = 0.0f;
      for (int k = 0; k < rr; ++k)
        fold(tr, ti, src[base + (k * m + p) * s + q], w[(j * k) % rr]);
      finish(tr, ti, j, p, th, dst, base + (p * rr + j) * s + q, scale_it,
             scale);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    fft_kernel(const float2* __restrict__ x, float2* __restrict__ y, int n,
               int rows, int group, FftStages st, int table, int inverse) {
  extern __shared__ float2 smem[];
  const int count = st.count;
  const int nbuf = count < 2 ? 0 : (count == 2 ? 1 : 2);
  float2* buf0 = smem;
  float2* buf1 = smem + (nbuf == 2 ? group * n : 0);
  float2* wtab = smem + nbuf * group * n;
  float* ttab = reinterpret_cast<float*>(wtab + table);
  const double sign = inverse ? 1.0 : -1.0;

  // per stage: the rr DFT weights, and the rr twiddle angle steps
  for (int idx = threadIdx.x; idx < table; idx += blockDim.x) {
    int t = 0, off = 0, n_cur = n;
    while (idx >= off + st.radix[t]) {
      off += st.radix[t];
      n_cur /= st.radix[t];
      ++t;
    }
    const int i = idx - off;
    const double ang = sign * 2.0 * kPi * i / st.radix[t];
    wtab[idx] = make_float2(static_cast<float>(cos(ang)),
                            static_cast<float>(sin(ang)));
    ttab[idx] = static_cast<float>(sign * 2.0 * kPi * i / n_cur);
  }
  __syncthreads();

  const bool scale_it = inverse != 0;
  const float scale = static_cast<float>(1.0 / n);
  const long long first = static_cast<long long>(blockIdx.x) * rows;
  for (int g0 = 0; g0 < rows; g0 += group) {
    const int gr = min(group, rows - g0);
    const float2* gsrc = x + (first + g0) * n;
    float2* gdst = y + (first + g0) * n;
    if (count == 0) {  // n = 1: the transform is the identity
      for (int e = threadIdx.x; e < gr * n; e += blockDim.x) gdst[e] = gsrc[e];
      continue;
    }
    int n_cur = n, s = 1, off = 0;
    for (int t = 0; t < count; ++t) {
      const int rr = st.radix[t];
      const bool last = t == count - 1;
      const float2* src = t == 0 ? gsrc : ((t - 1) & 1 ? buf1 : buf0);
      float2* dst = last ? gdst : (t & 1 ? buf1 : buf0);
      const float2* w = wtab + off;
      const float* th = ttab + off;
      const bool sc = last && scale_it;
      switch (rr) {
        case 2:
          stage_fixed<2>(src, dst, n, gr, n_cur, s, w, th, sc, scale);
          break;
        case 4:
          stage_fixed<4>(src, dst, n, gr, n_cur, s, w, th, sc, scale);
          break;
        case 8:
          stage_fixed<8>(src, dst, n, gr, n_cur, s, w, th, sc, scale);
          break;
        case 16:
          stage_fixed<16>(src, dst, n, gr, n_cur, s, w, th, sc, scale);
          break;
        default:
          stage_generic(src, dst, n, gr, n_cur, s, rr, w, th, sc, scale);
      }
      if (!last) __syncthreads();
      n_cur /= rr;
      s *= rr;
      off += rr;
    }
    __syncthreads();  // the next group rewrites the buffers
  }
}

}  // namespace

extern "C" {

// x, y: (batch, n) complex64 (interleaved f32 pairs), contiguous on the
// device; batch % rows == 0; prod(radix[:n_stages]) == n, every radix >= 2;
// unroll >= 1 (least butterflies a thread owns per stage); inverse 0 or 1.
int repro_fft(const void* x, void* y, long long batch, int n, int rows,
              const int* radix, int n_stages, int unroll, int inverse,
              void* stream) {
  if (rows < 1 || n < 1 || unroll < 1 || batch % rows || n_stages < 0 ||
      n_stages > kMaxStages)
    return cudaErrorInvalidValue;
  FftStages st;
  st.count = n_stages;
  long long prod = 1;
  int table = 0, rmax = 1;
  for (int t = 0; t < n_stages; ++t) {
    if (radix[t] < 2) return cudaErrorInvalidValue;
    st.radix[t] = radix[t];
    prod *= radix[t];
    table += radix[t];
    rmax = radix[t] > rmax ? radix[t] : rmax;
  }
  if (prod != n) return cudaErrorInvalidValue;
  const size_t tables = static_cast<size_t>(table) *
                        (sizeof(float2) + sizeof(float));
  if (tables > kSmemLimit) return cudaErrorInvalidValue;
  const int nbuf = n_stages < 2 ? 0 : (n_stages == 2 ? 1 : 2);
  long long group = rows;
  if (nbuf > 0) {
    const size_t per_row = nbuf * sizeof(float2) * static_cast<size_t>(n);
    const long long fit = static_cast<long long>((kSmemLimit - tables) /
                                                 per_row);
    if (fit < 1) return cudaErrorInvalidValue;
    group = fit < rows ? fit : rows;
  }
  const size_t smem = nbuf * sizeof(float2) * static_cast<size_t>(group) * n
                      + tables;
  const long long per_thread = static_cast<long long>(rmax) * unroll;
  long long threads = (group * n + per_thread - 1) / per_thread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const long long blocks = batch / rows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fft_kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(threads),
               smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float2*>(y), n, rows,
      static_cast<int>(group), st, table, inverse);
  return cudaGetLastError();
}

}  // extern "C"
