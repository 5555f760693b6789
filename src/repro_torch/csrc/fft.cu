// Hand-written Hopper kernels for the batched complex FFT: self-sorting
// mixed-radix Stockham, each row resident in shared memory.
//
//   repro_fft_pow2  replaces repro/kernels/fft/kernel.py fft_pallas for
//                   power-of-two rows of 16 to 8192 points with fan-ins 2,
//                   4, 8 and 16: every config of the h100 fft space (route
//                   "pow2");
//   repro_fft       the same function for any other row or stage sequence
//                   (ragged and prime stages such as (8, 6, 2) at n = 96
//                   and (2, 53) at n = 106, rows below 16 points; route
//                   "generic");
//   repro_fft_pass  one pass of the four-step driver (the JAX package's
//                   four_step_fft runs fft_pallas between XLA transposes
//                   and a twiddle multiply): the pow2 kernel on problems
//                   read at strides, the transpose folded into the first
//                   stage group's loads and the last one's stores, the
//                   twiddle into those stores, so that a pass reads and
//                   writes device memory once (see PassIo).
//
// Built with nvcc for sm_90a into the port's shared library (plain C
// interface, loaded with ctypes by repro_torch/kernels/build.py).  The
// entry points launch on the caller's stream, allocate nothing, and
// return cudaGetLastError() (or the error of the call that failed first).
//
// What they compute.  The DFT of each row of a (batch, n) complex64 array,
// in f32, written as complex64 (inverse: the conjugate transform scaled by
// 1/n at the store).  They follow the plan the tuner chose:
//   * `rows` rows make one program (a block's worth of rows resident at
//     once; the CUDA grid of the generic kernel is batch / rows, the pow2
//     kernel's a persistent grid whose blocks walk the programs);
//   * the plan's stage sequence (stage_radices, mixed radix included) is
//     passed by value.  Stage t views a row as (n_cur, s), s the product of
//     the earlier fan-ins, m = n_cur / rr, and for every (p < m, q < s)
//     reads x[(k m + p) s + q] for k < rr and writes
//       y[(p rr + j) s + q] = exp(i theta_j p) * sum_k x[(k m + p) s + q] w^(j k)
//     for j < rr, with w = exp(-+2 pi i / rr) and theta_j = -+2 pi j / n_cur
//     (+ for the inverse): the rr-point DFT folded over k in order, then the
//     twiddle, the radix digit innermost (self-sorting, no bit reversal);
//   * the first stage reads the input from device memory and the last one
//     writes the output there;
//   * `unroll` is launch geometry only (the TPU kernel does not read the
//     knob, and it changes no result here).
// Rounding.  Every multiply and add is __fmul_rn / __fadd_rn / __fsub_rn
// (no FMA contraction, no fast math), in the order of the plain version
// (primitives.butterfly): the DFT weights w^t are cos/sin in float64
// rounded to f32, as Python computes them; theta_j is rounded to f32, the
// product theta_j * p is taken in f32 and its cos/sin by sincosf (the
// precise libdevice version, which may differ from PyTorch's by an ulp).
// The pow2 kernel keeps that order and those values, so both kernels equal
// fft_plain bit for bit.  Where a weight is w^0 = (1, -+0) exactly, its
// product is skipped: x * 1 - y * 0 is x (a zero's sign aside, which the
// sum starting from +0 never keeps), so the sums are unchanged.
//
// What bounds it on the card: memory bandwidth at the paper's sizes (16
// bytes an element: one complex64 read, one written), with log_rr(n)
// stages of on-chip work; the rr-point DFT is folded directly (rr complex
// multiply-adds an output, as on the TPU), so radix 16 costs more
// operations than radix 2.  The generic kernel (route "generic",
// fft_kernel below) was held back by that on-chip work: a precise sincosf
// for every output with j > 0 of every stage (its slow path's local array
// is the kernel's stack frame), two runtime integer divisions a butterfly,
// and two shared buffers of rows * n points (128 KB at rows 8) behind 92
// registers x 512 threads, one block an SM.  The pow2 kernel does this
// instead:
//   * the twiddles exp(i theta_j p) of every stage (sum of (rr - 1) m, about
//     n values) and the DFT weights are tabled in shared memory once per
//     block, by the kernel's own expression, and the grid is persistent
//     (as many blocks as fit on the card, each walking programs), so the
//     table is built once per block on an SM, not once per program;
//   * n and s are powers of two: a butterfly's row, p and q, and its input
//     and output offsets, are shifts and masks; the stage is specialised on
//     the fan-ins of its group, its loops unrolled;
//   * consecutive stages whose fan-ins multiply to at most 16 run as one
//     group in registers (StageGroup: radix 4 pairs its stages, radix 2
//     takes four at a time), so a row goes through shared memory once a
//     group, not once a stage: three times at n = 1024 for radix 2, 4, 8
//     and 16 alike.  A group's butterflies are the stages' own, point for
//     point, so the arithmetic and its order do not change;
//   * each thread holds 16 points (32 at unroll >= 2) of every group in
//     registers; the block reads them all, waits at one barrier, then
//     writes the outputs in place into the one shared buffer, so a block
//     of at most 256 threads holds 4096 points (8192 at 32 a thread; one
//     row of 8192 takes 512 threads of 16), 34 KB with its padding, and
//     two blocks share an SM at 128 registers a thread;
//   * reads of a stage are coalesced (lane i reads point i of a run), in
//     shared and in device memory; the shared buffer puts a pad slot after
//     every 16 points, which spreads the strided writes of the early stages
//     (p rr + j) s + q over the banks.

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

// ---------------------------------------------------------------------------
// The pow2 kernel (route "pow2")
// ---------------------------------------------------------------------------

constexpr int kPow2MinN = 16;
constexpr int kPow2MaxN = 8192;
// Blocks take programs' rows in groups of at most kPow2BlockThreads
// threads' points (two blocks an SM), or one row where a row needs more
// (n = 8192 at 16 points a thread: 512 threads).
constexpr int kPow2BlockThreads = 256;
constexpr int kPow2MaxThreads = 512;

struct Pow2Stages {
  int log_r[kMaxStages];
  // the stages in register groups (StageGroup): first stage, stages and
  // code of each group
  int groups;
  int group_first[kMaxStages];
  int group_size[kMaxStages];
  int group_code[kMaxStages];
};

// Stage t of the plan: its weights start at w_off and twiddles at tw_off
// in the tables; (log2 s, log2 m) as the stage views a row.
struct StageView {
  int log_s, log_m, w_off, tw_off;
};

__device__ __forceinline__ StageView stage_view(const Pow2Stages& st,
                                                int log_n, int t) {
  StageView v{0, 0, 0, 0};
  for (int u = 0; u < t; ++u) {
    const int r = 1 << st.log_r[u];
    const int m = 1 << (log_n - v.log_s - st.log_r[u]);
    v.w_off += r;
    v.tw_off += (r - 1) * m;
    v.log_s += st.log_r[u];
  }
  v.log_m = log_n - v.log_s - st.log_r[t];
  return v;
}

// A group of up to four consecutive stages (fan-ins 2^L1 ... 2^L4, L = 0
// for an absent stage) whose fan-ins multiply to P <= 16: one thread runs
// all of them on P points in registers.  With s the stride and n_t the
// length (n / s) at the group's first stage, and m_l = n_t / (R_1 ... R_l),
// the thread that owns (p, q), p < n_t / P, q < s, reads the points
//   (k_1 m_1 + ... + k_U m_U + p) s + q
// (register K = k_1 + R_1 (k_2 + R_2 (...)), digit 1 lowest); stage i is
// the butterfly over digit i of every register set that shares the other
// digits, at the stage's own p_i = p + sum_{l > i} k_l m_l, its outputs j_i
// replacing k_i; register J = j_1 + R_1 (j_2 + ...) then lands at
//   p (P s) + J s + q.
// Each stage's butterflies are exactly those of the stage alone (the same
// points, weights, twiddles and order), so the results are the same bits.
template <int L1, int L2, int L3, int L4>
struct StageGroup {
  __host__ __device__ static constexpr int l(int i) {
    return i == 0 ? L1 : i == 1 ? L2 : i == 2 ? L3 : L4;
  }
  __host__ __device__ static constexpr int shift(int i) {   // digit i's bits
    return i == 0 ? 0 : i == 1 ? L1 : i == 2 ? L1 + L2 : L1 + L2 + L3;
  }
  static constexpr int kCount = (L1 > 0) + (L2 > 0) + (L3 > 0) + (L4 > 0);
  static constexpr int kLogP = L1 + L2 + L3 + L4;
  static constexpr int kP = 1 << kLogP;
};

// Point i of the resident rows sits at i + i / 16 in the shared buffer:
// one pad slot every 16 points spreads a group's strided writes over the
// banks (radix 16's first stage writes 16 points apart).
__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// Point i of the resident rows with `skew` more slots after each row of
// 2^log_n points: padded(i) where the skew is 0.
__device__ __forceinline__ int shared_at(int i, int log_n, int skew) {
  return padded(i) + (i >> log_n) * skew;
}

// How a stage group meets device memory: point i of resident row `row` is
// read from src[in_at(...)] by the first group and written to dst[out_at]
// by the last; across_rows(loads, stores) says whether a group that loads
// or stores there walks its lanes across the rows.  RowIo is the pow2
// kernel's: contiguous rows, a warp's lanes along a row, no skew, no
// twiddle.
struct RowIo {
  static constexpr bool kTwiddles = false;
  static constexpr int skew = 0;
  __device__ __forceinline__ bool across_rows(bool, bool) const {
    return false;
  }
  __device__ __forceinline__ int in_at(int row, int i, int log_n) const {
    return (row << log_n) + i;
  }
  __device__ __forceinline__ int out_at(int row, int i, int log_n) const {
    return (row << log_n) + i;
  }
};

// The four-step pass's (repro_fft_pass): resident row r is problem
// c = c0 + r of a batch item, its point t at (c >> log_lo) in_hs +
// (c & lo_mask) + t in_ps and its output k at the same with out_hs, out_ps,
// every stride a power of two (a shift) and every offset within the item
// below 2^31.  Where a group meets device memory at a point stride other
// than 1 its lanes walk across the rows, which are adjacent problems
// (adjacent addresses: the transpose is the addressing), and the rows lie
// `skew` slots apart in shared memory so that such lanes meet distinct
// banks.  With TW, output k is multiplied by exp(-+2 pi i e / tw_n), e =
// ((c & lo_mask) >> log_div) (k tw_kmul + (c >> log_lo)): the integer e in
// f32, times the f32 of -+2 pi, times 1 / tw_n (exact: a power of two);
// |angle| < 2 pi.  A pass without a twiddle instantiates no sincosf, and a
// pass with one calls it in a function of its own: inlined into the last
// stage's unrolled stores it costs registers and code even where untaken.
// (H100, 2^26 points, 256-point rows: 1.12 ms a pass with the copies
// present and untaken, 0.93 without them, the pow2 kernel 0.87; the
// twiddle adds 0.25 ms called, 0.32 inlined.)
__device__ __noinline__ float2 twiddle_of(int e, float sign_2pi,
                                          float tw_scale) {
  const float ang =
      __fmul_rn(__fmul_rn(__int2float_rn(e), sign_2pi), tw_scale);
  float sn, cs;
  sincosf(ang, &sn, &cs);
  return make_float2(cs, sn);
}

struct PassFields {
  int c0, lo_mask, log_lo, log_in_ps, log_in_hs, log_out_ps, log_out_hs,
      log_div, log_kmul, skew;
  float tw_scale, sign_2pi;
};

template <bool TW>
struct PassIo : PassFields {
  static constexpr bool kTwiddles = TW;
  __device__ __forceinline__ bool across_rows(bool loads,
                                              bool stores) const {
    return (loads && log_in_ps != 0) || (stores && log_out_ps != 0);
  }
  __device__ __forceinline__ int in_at(int row, int i, int) const {
    const int c = c0 + row;
    return ((c >> log_lo) << log_in_hs) + (c & lo_mask) + (i << log_in_ps);
  }
  __device__ __forceinline__ int out_at(int row, int k, int) const {
    const int c = c0 + row;
    return ((c >> log_lo) << log_out_hs) + (c & lo_mask) + (k << log_out_ps);
  }
  __device__ __forceinline__ void store(float2* dst, int row, int k,
                                        float2 v) const {
    const int c = c0 + row;
    const int e =
        ((c & lo_mask) >> log_div) * ((k << log_kmul) + (c >> log_lo));
    const float2 w = twiddle_of(e, sign_2pi, tw_scale);   // (cos, sin)
    dst[out_at(row, k, 0)] =
        make_float2(__fsub_rn(__fmul_rn(v.x, w.x), __fmul_rn(v.y, w.y)),
                    __fadd_rn(__fmul_rn(v.x, w.y), __fmul_rn(v.y, w.x)));
  }
};

// Stage I of a group on one thread's P registers (see StageGroup).  The
// group's last stage writes its outputs to dst (register J at point
// out + J s of row `row`) instead of back to the registers.
template <class G, int I, int P, bool LAST, class Io>
__device__ __forceinline__ void register_stage(
    float2 (&v)[P], int p, const int (&log_m)[4], const float2* w,
    const float2* tw, bool scale_it, float scale, float2* dst,
    bool dst_shared, int row, int out, int log_s, int log_n, const Io& io) {
  constexpr int LR = G::l(I);
  constexpr int R = 1 << LR;
  constexpr int SH = G::shift(I);
#pragma unroll
  for (int o = 0; o < P; ++o) {
    if ((o >> SH) & (R - 1)) continue;   // o: the other digits, digit I = 0
    int pi = p;
#pragma unroll
    for (int l = I + 1; l < 4; ++l)
      pi += ((o >> G::shift(l)) & ((1 << G::l(l)) - 1)) << log_m[l];
    float2 t[LAST ? 1 : R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float tr = 0.0f, ti = 0.0f;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float2 xk = v[o + (k << SH)];
        const int e = (j * k) & (R - 1);
        if (e == 0) {   // w^0 = (1, -+0): the product is x itself
          tr = __fadd_rn(tr, xk.x);
          ti = __fadd_rn(ti, xk.y);
        } else {
          fold(tr, ti, xk, w[e]);
        }
      }
      if (j != 0) {
        const float2 c = tw[((j - 1) << log_m[I]) + pi];
        const float nr = __fsub_rn(__fmul_rn(tr, c.x), __fmul_rn(ti, c.y));
        const float ni = __fadd_rn(__fmul_rn(tr, c.y), __fmul_rn(ti, c.x));
        tr = nr;
        ti = ni;
      }
      if (scale_it) {
        tr = __fmul_rn(tr, scale);
        ti = __fmul_rn(ti, scale);
      }
      if constexpr (LAST) {
        const int at = out + ((o + (j << SH)) << log_s);
        if constexpr (Io::kTwiddles) {
          if (dst_shared)
            dst[shared_at((row << log_n) + at, log_n, io.skew)] =
                make_float2(tr, ti);
          else
            io.store(dst, row, at, make_float2(tr, ti));
        } else {
          dst[dst_shared ? shared_at((row << log_n) + at, log_n, io.skew)
                         : io.out_at(row, at, log_n)] = make_float2(tr, ti);
        }
      } else {
        t[j] = make_float2(tr, ti);
      }
    }
    if constexpr (!LAST) {
#pragma unroll
      for (int j = 0; j < R; ++j) v[o + (j << SH)] = t[j];
    }
  }
}

// The views of a group's stages: stride of its first, and per stage its
// log2 m and where its weights and twiddles start in the tables.
struct GroupView {
  int log_s;
  int log_m[4];
  int w_off[4];
  int tw_off[4];
};

// Unit u of `gr` rows of 2^log_units units: along the rows (row-major), or
// across them (consecutive units in consecutive rows; gr a power of two).
__device__ __forceinline__ void unit_of(int u, bool across, int gr,
                                        int log_units, int& row, int& rem) {
  if (across) {
    row = u & (gr - 1);
    rem = u >> (__ffs(gr) - 1);
  } else {
    row = u >> log_units;
    rem = u & ((1 << log_units) - 1);
  }
}

// One group over `gr` resident rows: thread threadIdx.x owns the units
// (row, p, q) threadIdx.x + b * blockDim.x, b < C / P.  Reads all its
// points, waits (in place, when src is the shared buffer), runs the
// group's stages in registers, the last one writing its outputs.
template <int L1, int L2, int L3, int L4, int C, class Io>
__device__ __forceinline__ void group_pass(
    const float2* src, float2* dst, bool src_shared, bool dst_shared, int gr,
    int log_n, const GroupView& gv, const float2* wtab, const float2* twtab,
    bool scale_last, float scale, const Io& io) {
  using G = StageGroup<L1, L2, L3, L4>;
  constexpr int P = G::kP;
  constexpr int B = C / P;
  constexpr int U = G::kCount;
  const int log_units = log_n - G::kLogP;   // units in a row: n / P
  const int total = gr << log_units;
  const int threads = blockDim.x;
  const bool across = io.across_rows(!src_shared, !dst_shared);
  float2 v[B][P];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = threadIdx.x + b * threads;
    if (u >= total) continue;
    int row, rem;
    unit_of(u, across, gr, log_units, row, rem);
#pragma unroll
    for (int K = 0; K < P; ++K) {
      int off = rem;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        off += ((K >> G::shift(l)) & ((1 << G::l(l)) - 1))
               << (log_n - G::shift(l) - G::l(l));
      v[b][K] = src[src_shared ? shared_at((row << log_n) + off, log_n, io.skew)
                               : io.in_at(row, off, log_n)];
    }
  }
  if (src_shared) __syncthreads();   // every read before any write
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int u = threadIdx.x + b * threads;
    if (u >= total) continue;
    int row, rem;
    unit_of(u, across, gr, log_units, row, rem);
    const int p = rem >> gv.log_s;
    const int q = rem & ((1 << gv.log_s) - 1);
    const int out = (p << (gv.log_s + G::kLogP)) + q;
#define REPRO_STAGE(I)                                                      \
    register_stage<G, I, P, U == I + 1>(                                    \
        v[b], p, gv.log_m, wtab + gv.w_off[I], twtab + gv.tw_off[I],        \
        scale_last && U == I + 1, scale, dst, dst_shared, row, out,         \
        gv.log_s, log_n, io);
    REPRO_STAGE(0)
    if constexpr (U > 1) { REPRO_STAGE(1) }
    if constexpr (U > 2) { REPRO_STAGE(2) }
    if constexpr (U > 3) { REPRO_STAGE(3) }
#undef REPRO_STAGE
  }
  if (dst_shared) __syncthreads();
}

// Group g's view (the loop is unrolled so that gv's arrays stay in
// registers).
__device__ __forceinline__ GroupView group_view(const Pow2Stages& st,
                                                int log_n, int g) {
  GroupView gv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = i < st.group_size[g];
    const StageView v = stage_view(st, log_n, in ? st.group_first[g] + i : 0);
    if (i == 0) gv.log_s = v.log_s;
    gv.log_m[i] = in ? v.log_m : 0;
    gv.w_off[i] = in ? v.w_off : 0;
    gv.tw_off[i] = in ? v.tw_off : 0;
  }
  return gv;
}

// The tables, once per block: per stage its rr DFT weights, and its
// (rr - 1) m twiddles exp(i theta_j p), j >= 1, at (j - 1) m + p.
__device__ __forceinline__ void pow2_tables(const Pow2Stages& st, int log_n,
                                            int w_count, int tw_count,
                                            int inverse, float2* wtab,
                                            float2* twtab) {
  const int n = 1 << log_n;
  const double sign = inverse ? 1.0 : -1.0;
  for (int idx = threadIdx.x; idx < w_count + tw_count;
       idx += blockDim.x) {
    int t = 0, log_s = 0, off = idx < w_count ? idx : idx - w_count;
    if (idx < w_count) {
      while (off >= (1 << st.log_r[t])) {
        off -= 1 << st.log_r[t];
        ++t;
      }
      const int r = 1 << st.log_r[t];
      const double ang = sign * 2.0 * kPi * off / r;
      wtab[idx] = make_float2(static_cast<float>(cos(ang)),
                              static_cast<float>(sin(ang)));
    } else {
      int m = n >> st.log_r[0];
      while (off >= ((1 << st.log_r[t]) - 1) * m) {
        off -= ((1 << st.log_r[t]) - 1) * m;
        log_s += st.log_r[t];
        ++t;
        m = n >> (log_s + st.log_r[t]);
      }
      const int n_cur = n >> log_s;
      const int j = 1 + off / m;
      const int p = off - (j - 1) * m;
      const float th = static_cast<float>(sign * 2.0 * kPi * j / n_cur);
      float sn, cs;
      sincosf(__fmul_rn(th, static_cast<float>(p)), &sn, &cs);
      twtab[idx - w_count] = make_float2(cs, sn);
    }
  }
}

// The group codes the host passes: L1 | L2 << 3 | L3 << 6 | L4 << 9, every
// ordered split of log2 P <= 4 into fan-ins 2 ... 16.
#define REPRO_GROUP_CASES(X) \
  X(1, 0, 0, 0) X(2, 0, 0, 0) X(1, 1, 0, 0) X(3, 0, 0, 0) X(1, 2, 0, 0) \
  X(2, 1, 0, 0) X(1, 1, 1, 0) X(4, 0, 0, 0) X(1, 3, 0, 0) X(3, 1, 0, 0) \
  X(2, 2, 0, 0) X(1, 1, 2, 0) X(1, 2, 1, 0) X(2, 1, 1, 0) X(1, 1, 1, 1)

__host__ __device__ constexpr int group_code(int l1, int l2, int l3,
                                           int l4) {
  return l1 | l2 << 3 | l3 << 6 | l4 << 9;
}

template <int C, class Io = RowIo>
__device__ __forceinline__ void group_dispatch(
    int code, const float2* src, float2* dst, bool src_shared,
    bool dst_shared, int gr, int log_n, const GroupView& gv,
    const float2* wtab, const float2* twtab, bool scale_last, float scale,
    const Io& io = Io()) {
  switch (code) {
#define REPRO_GROUP_CASE(A, B, C_, D)                                     \
  case group_code(A, B, C_, D):                                           \
    group_pass<A, B, C_, D, C>(src, dst, src_shared, dst_shared, gr, log_n, \
                               gv, wtab, twtab, scale_last, scale, io);   \
    break;
    REPRO_GROUP_CASES(REPRO_GROUP_CASE)
#undef REPRO_GROUP_CASE
    default: break;
  }
}

// 128 registers a thread at 16 points (the occupancy of two blocks of 256
// threads beats spill-free code at one block: measured on the H100), 255
// at 32.
template <int C>
__global__ void __launch_bounds__(C == 16 ? kPow2MaxThreads
                                          : kPow2BlockThreads, 1)
    fft_pow2_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    int log_n, int rows, int group, long long programs,
                    Pow2Stages st, int w_count, int tw_count, int inverse) {
  extern __shared__ float2 smem[];
  const int n = 1 << log_n;
  float2* buf = smem;
  float2* wtab = smem + padded(group * n);
  float2* twtab = wtab + w_count;
  pow2_tables(st, log_n, w_count, tw_count, inverse, wtab, twtab);
  __syncthreads();

  const bool scale_it = inverse != 0;
  const float scale = static_cast<float>(1.0 / n);
  const int per_program = (rows + group - 1) / group;
  const long long groups = programs * per_program;
  for (long long gid = blockIdx.x; gid < groups; gid += gridDim.x) {
    const long long prog = gid / per_program;
    const int g0 = static_cast<int>(gid - prog * per_program) * group;
    const int gr = min(group, rows - g0);
    const long long first = prog * rows + g0;
    const float2* gsrc = x + (first << log_n);
    float2* gdst = y + (first << log_n);
    for (int g = 0; g < st.groups; ++g) {
      const bool first_group = g == 0, last = g == st.groups - 1;
      const float2* src = first_group ? gsrc : buf;
      float2* dst = last ? gdst : buf;
      const GroupView gv = group_view(st, log_n, g);
      group_dispatch<C>(st.group_code[g], src, dst, !first_group, !last, gr,
                        log_n, gv, wtab, twtab, last && scale_it, scale);
    }
  }
}

// The pow2 kernel's geometry for a plan: rows resident at once (group),
// threads, table sizes and shared memory; false where it does not take the
// plan (the wrapper's route function never sends such a plan here).
struct Pow2Geometry {
  Pow2Stages st;
  int log_n, group, threads, points, w_count, tw_count;
  size_t smem;
};

bool pow2_geometry(int n, int rows, const int* radix, int n_stages,
                   int unroll, Pow2Geometry* g) {
  if (n < kPow2MinN || n > kPow2MaxN || (n & (n - 1)) || rows < 1 ||
      unroll < 1 || n_stages < 1 || n_stages > kMaxStages)
    return false;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  g->log_n = log_n;
  g->w_count = g->tw_count = 0;
  int log_s = 0;
  for (int t = 0; t < n_stages; ++t) {
    const int r = radix[t];
    const int lr = r == 2 ? 1 : r == 4 ? 2 : r == 8 ? 3 : r == 16 ? 4 : 0;
    if (lr == 0) return false;
    g->st.log_r[t] = lr;
    g->w_count += r;
    g->tw_count += (r - 1) * (n >> (log_s + lr));
    log_s += lr;
  }
  if (log_s != log_n) return false;
  // register groups: consecutive stages while their fan-ins multiply to
  // at most 16 points
  Pow2Stages& st = g->st;
  st.groups = 0;
  for (int t = 0; t < n_stages;) {
    int size = 0, log_p = 0, code = 0;
    while (t + size < n_stages && size < 4 &&
           log_p + st.log_r[t + size] <= 4) {
      code |= st.log_r[t + size] << (3 * size);
      log_p += st.log_r[t + size];
      ++size;
    }
    if (size == 0) return false;
    st.group_first[st.groups] = t;
    st.group_size[st.groups] = size;
    st.group_code[st.groups] = code;
    ++st.groups;
    t += size;
  }
  // 16 points a thread, 32 at unroll >= 2
  g->points = unroll >= 2 ? 32 : 16;
  const int fit = kPow2BlockThreads * g->points / n;
  const int max_rows = fit > 1 ? fit : 1;
  g->group = rows < max_rows ? rows : max_rows;
  const size_t tables = sizeof(float2) * (g->w_count + g->tw_count);
  auto buffer = [n](int group) {   // group rows, padded
    const size_t points = static_cast<size_t>(group) * n;
    return sizeof(float2) * (points + points / 16);
  };
  while (g->group > 1 && tables + buffer(g->group) > kSmemLimit) --g->group;
  g->threads = (g->group * n + g->points - 1) / g->points;
  g->smem = tables + buffer(g->group);
  return g->smem <= kSmemLimit;
}

template <int C>
cudaError_t launch_pow2(const float2* x, float2* y, long long batch,
                        int rows, const Pow2Geometry& g, int inverse,
                        cudaStream_t stream) {
  auto kernel = fft_pow2_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, g.threads, g.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long programs = batch / rows;
  const long long groups = programs * ((rows + g.group - 1) / g.group);
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > groups) blocks = groups;
  if (blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(blocks), g.threads, g.smem, stream>>>(
      x, y, g.log_n, rows, g.group, programs, g.st, g.w_count, g.tw_count,
      inverse);
  return cudaGetLastError();
}

// The four-step pass (repro_fft_pass): the pow2 kernel's loop on PassIo.
// A program is `group` adjacent problems of a batch item, all resident at
// once: the first stage group loads them from device memory, the last one
// stores them, each access of a warp a run over adjacent problems.
template <int C, bool TW>
__global__ void __launch_bounds__(C == 16 ? kPow2MaxThreads
                                          : kPow2BlockThreads, 1)
    fft_pass_kernel(const float2* __restrict__ x, float2* __restrict__ y,
                    int log_n, int group, long long programs, Pow2Stages st,
                    int w_count, int tw_count, int inverse, long long total,
                    PassIo<TW> io) {
  extern __shared__ float2 smem[];
  const int n = 1 << log_n;
  float2* buf = smem;
  float2* wtab = smem + shared_at(group << log_n, log_n, io.skew);
  float2* twtab = wtab + w_count;
  pow2_tables(st, log_n, w_count, tw_count, inverse, wtab, twtab);
  __syncthreads();

  const bool scale_it = inverse != 0;
  const float scale = static_cast<float>(1.0 / n);
  const long long per_item = (total >> log_n) / group;
  for (long long gid = blockIdx.x; gid < programs; gid += gridDim.x) {
    const long long item = gid / per_item;
    io.c0 = static_cast<int>(gid - item * per_item) * group;
    const float2* gsrc = x + item * total;
    float2* gdst = y + item * total;
    for (int g = 0; g < st.groups; ++g) {
      const bool first_group = g == 0, last = g == st.groups - 1;
      const GroupView gv = group_view(st, log_n, g);
      group_dispatch<C>(st.group_code[g], first_group ? gsrc : buf,
                        last ? gdst : buf, !first_group, !last, group, log_n,
                        gv, wtab, twtab, last && scale_it, scale, io);
    }
  }
}

template <int C, bool TW>
cudaError_t launch_pass(const float2* x, float2* y, long long programs,
                        const Pow2Geometry& g, int inverse, long long total,
                        const PassIo<TW>& io, cudaStream_t stream) {
  auto kernel = fft_pass_kernel<C, TW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, g.threads, g.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  long long blocks = static_cast<long long>(sms) * per_sm;
  if (blocks > programs) blocks = programs;
  if (blocks == 0) return cudaSuccess;
  kernel<<<static_cast<unsigned>(blocks), g.threads, g.smem, stream>>>(
      x, y, g.log_n, g.group, programs, g.st, g.w_count, g.tw_count, inverse,
      total, io);
  return cudaGetLastError();
}

int log2_exact(long long v) {   // -1 unless v is a power of two
  if (v < 1 || (v & (v - 1))) return -1;
  int l = 0;
  while ((1LL << l) < v) ++l;
  return l;
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

// The pow2 kernel (route "pow2"): same arguments and contract as
// repro_fft; returns cudaErrorInvalidValue for a plan it does not take
// (n not a power of two from 16 to 8192, a fan-in other than 2, 4, 8, 16,
// or tables and one row beyond a block's shared memory).
int repro_fft_pow2(const void* x, void* y, long long batch, int n, int rows,
                   const int* radix, int n_stages, int unroll, int inverse,
                   void* stream) {
  if (rows < 1 || batch % rows) return cudaErrorInvalidValue;
  Pow2Geometry g;
  if (!pow2_geometry(n, rows, radix, n_stages, unroll, &g))
    return cudaErrorInvalidValue;
  auto xs = static_cast<const float2*>(x);
  auto ys = static_cast<float2*>(y);
  auto strm = static_cast<cudaStream_t>(stream);
  if (g.points == 16)
    return launch_pow2<16>(xs, ys, batch, rows, g, inverse, strm);
  return launch_pow2<32>(xs, ys, batch, rows, g, inverse, strm);
}

// One pass of a four-step FFT over (batch, total) complex64 x into y (both
// contiguous on the device, distinct): each batch item holds total / n
// problems c of n points; problem c's point t lies at
//   (c / lo) in_hs + (c % lo) + t in_ps
// of the item, and its output k goes to the same with out_hs, out_ps (the
// caller makes that a bijection).  Output k of problem c is the n-point DFT
// of its points (inverse: the conjugate one, scaled by 1/n), as the pow2
// kernel computes it on the plan's stages, then, where tw_n > 0, multiplied
// by exp(-+2 pi i e / tw_n) with e = ((c % lo) / tw_div) (k tw_kmul +
// c / lo).  layout = {total, lo, in_ps, in_hs, out_ps, out_hs, tw_n, tw_div,
// tw_kmul}; `problems` adjacent problems (dividing total / n) are resident in
// a block at once.  Takes what the pow2 kernel takes (n from 16 to 8192,
// fan-ins 2 ... 16), with total below 2^31, `problems` and every stride,
// tw_div, tw_kmul and tw_n (when not 0) powers of two, at most 512 threads
// of 16 points (256 of 32 at unroll >= 2), and the rows and the tables
// within a block's shared memory; cudaErrorInvalidValue otherwise.
int repro_fft_pass(const void* x, void* y, long long batch, int n,
                   int problems, const int* radix, int n_stages, int unroll,
                   int inverse, const long long* layout, void* stream) {
  const long long total = layout[0], tw_n = layout[6];
  int logs[9];
  for (int i = 1; i < 9; ++i)
    logs[i] = i == 6 ? (tw_n ? log2_exact(tw_n) : 0) : log2_exact(layout[i]);
  bool valid = batch >= 0 && n >= 1 && total >= n && total % n == 0 &&
               total < (1LL << 31) && log2_exact(problems) >= 0 &&
               (total / n) % problems == 0;
  for (int i = 1; i < 9; ++i) valid = valid && logs[i] >= 0;
  if (!valid) return cudaErrorInvalidValue;
  Pow2Geometry g;
  if (!pow2_geometry(n, problems, radix, n_stages, unroll, &g))
    return cudaErrorInvalidValue;
  PassFields io;
  io.c0 = 0;
  io.lo_mask = static_cast<int>(layout[1] - 1);
  io.log_lo = logs[1];
  io.log_in_ps = logs[2];
  io.log_in_hs = logs[3];
  io.log_out_ps = logs[4];
  io.log_out_hs = logs[5];
  io.log_div = logs[7];
  io.log_kmul = logs[8];
  // rows 16 / problems slots off the banks (one from 16 problems up)
  io.skew = problems >= 16 ? 1 : 16 / problems;
  io.tw_scale = tw_n ? static_cast<float>(1.0 / tw_n) : 0.0f;
  io.sign_2pi = static_cast<float>((inverse ? 1.0 : -1.0) * 2.0 * kPi);
  // every problem of a program resident at once
  const size_t points = static_cast<size_t>(problems) * n;
  g.group = problems;
  g.threads = static_cast<int>((points + g.points - 1) / g.points);
  g.smem = sizeof(float2) * (g.w_count + g.tw_count + points + points / 16 +
                             static_cast<size_t>(problems) * io.skew);
  if (g.threads > (g.points == 16 ? kPow2MaxThreads : kPow2BlockThreads) ||
      g.smem > kSmemLimit)
    return cudaErrorInvalidValue;
  const long long programs = batch * (total / n / problems);
  auto xs = static_cast<const float2*>(x);
  auto ys = static_cast<float2*>(y);
  auto strm = static_cast<cudaStream_t>(stream);
  if (tw_n) {
    PassIo<true> tio;
    static_cast<PassFields&>(tio) = io;
    if (g.points == 16)
      return launch_pass<16>(xs, ys, programs, g, inverse, total, tio, strm);
    return launch_pass<32>(xs, ys, programs, g, inverse, total, tio, strm);
  }
  PassIo<false> pio;
  static_cast<PassFields&>(pio) = io;
  if (g.points == 16)
    return launch_pass<16>(xs, ys, programs, g, inverse, total, pio, strm);
  return launch_pass<32>(xs, ys, programs, g, inverse, total, pio, strm);
}

}  // extern "C"
