// Hopper (sm_90a) building blocks shared by the tensor-core kernels
// (csrc/matmul.cu, csrc/attention.cu) and the SSD kernels (csrc/ssd.cu):
// plain inline PTX, no CUTLASS.
//
//   * wgmma shared-memory descriptors for 128-byte-swizzled tiles, as TMA
//     writes them with CU_TENSOR_MAP_SWIZZLE_128B;
//   * wgmma.fence / commit_group / wait_group and the m64nNk16 bf16 -> f32
//     products, A from shared memory (_ss) or from registers (_rs), with
//     the B-transpose bit as a template argument; setmaxnreg;
//   * mbarrier init / arrive / arrive.expect_tx / try_wait.parity;
//   * cp.async.bulk.tensor 2d / 3d loads (TMA) completing on an mbarrier,
//     and 2d prefetches into L2;
//   * the host's cuTensorMapEncodeTiled, fetched from the driver library
//     at run time, so the shared library links without -lcuda (make_map;
//     make_map_bf16 for the tensor-core kernels' operands).
//
// Layout conventions (bf16, 128-byte swizzle).  A tile whose rows are 64
// elements (128 bytes) wide is stored row after row; eight rows form a
// 1024-byte swizzle atom, so every tile base is 1024-byte aligned.
//   * K-major operand (the reduction dim contiguous in a row): the stride
//     between 8-row groups (SBO) is 1024 bytes; a k16 step inside the
//     64-wide row advances the start address by 32 bytes.
//   * MN-major operand (B with the transpose bit: the output dim
//     contiguous, one row per k): 64-wide column chunks lie kChunk bytes
//     apart (LBO), 8-k-row groups 1024 bytes apart (SBO); a k16 step
//     advances the start address by 16 rows, 2048 bytes.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace sm90 {

// error codes above cudaError_t's range, for the host helpers below
// (repro_error_string in scan.cu spells them out)
constexpr int kErrNoEncoder = 20000;  // no cuTensorMapEncodeTiled found
constexpr int kErrEncode = 20001;     // + CUresult: the encode refused

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a 128-byte-swizzled tile at p (1024-byte aligned
// atoms; p itself may sit 32-byte steps into an atom for a k16 step)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= 1ull << 62;  // layout type 1: 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous product (wgmma writes them after the asm returns)
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// move registers between warpgroups: a producer gives some up, the
// consumers take them (all four warps of a warpgroup execute it; the
// kernel's roles must split in one if / else that never rejoins)
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

#define SM90_D8(i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 64 f32) = A (64 x 16, shared) . B (16 x 64, shared) [+ D]
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// D (64 x 128 f32) = A (64 x 16, shared) . B (16 x 128, shared) [+ D]
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56)
      : "l"(da), "l"(db), "r"(scale_d), "n"(kTransB));
}

// D (64 x 64 f32) = A (64 x 16 bf16, registers) . B (16 x 64, shared) [+ D]
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTransB));
}

// D (64 x 128 f32) = A (64 x 16 bf16, registers) . B (16 x 128, shared) [+ D]
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTransB));
}

// D (64 x 256 f32) = A (64 x 16 bf16, registers) . B (16 x 256, shared) [+ D]
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
      "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
      "%119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      :
        SM90_D8(0), SM90_D8(8), SM90_D8(16), SM90_D8(24), SM90_D8(32),
        SM90_D8(40), SM90_D8(48), SM90_D8(56), SM90_D8(64), SM90_D8(72),
        SM90_D8(80), SM90_D8(88), SM90_D8(96), SM90_D8(104), SM90_D8(112),
        SM90_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(kTransB));
}

#undef SM90_D8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- mbarrier --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// ask TMA to bring a box into L2 (nothing lands in shared memory)
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global [%0, {%1, %2}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}

// ---- host: tensor maps -----------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A tensor map of rank 2 or 3 over a contiguous tensor of elem_bytes-byte
// elements whose dims (innermost first) are dims[0..rank), boxes box[0..
// rank), the given swizzle (with CU_TENSOR_MAP_SWIZZLE_128B a box row is
// at most 128 bytes).  Elements outside the tensor read as zero.  Returns
// 0 or an error code (kErrNoEncoder, kErrEncode + CUresult).
inline int make_map(CUtensorMap* map, CUtensorMapDataType type,
                    uint32_t elem_bytes, const void* base, int rank,
                    const uint64_t* dims, const uint32_t* box,
                    CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t bdim[3], estride[3] = {1, 1, 1};
  uint64_t pitch = elem_bytes;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    if (i > 0) gstride[i - 1] = pitch;
    pitch *= dims[i];
  }
  const CUresult r = fn(map, type, static_cast<cuuint32_t>(rank),
                        const_cast<void*>(base), gdim, gstride, bdim, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// The tensor-core kernels' operands: bf16, box[0] 64 elements (one
// 128-byte swizzle row).
inline int make_map_bf16(CUtensorMap* map, const void* base, int rank,
                         const uint64_t* dims, const uint32_t* box) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, rank, dims,
                  box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90
