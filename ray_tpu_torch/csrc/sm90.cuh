// Hopper (sm_90a) building blocks shared by the port's kernels: TMA tensor
// maps and loads, mbarriers, warpgroup register reallocation and the
// warpgroup MMA (wgmma) with its shared-memory descriptors.
//
// Layout every user of this header keeps: a tile of R rows whose inner
// dimension is a multiple of 64 bf16 values is stored as 64-column "halves"
// of R x 128 bytes each, written by TMA with CU_TENSOR_MAP_SWIZZLE_128B
// (inner box 64 elements), every half 1024-byte aligned.  The descriptors
// below read that layout either K-major (rows = M or N, the 64 columns =
// K) or MN-major (rows = K, columns = N; the transposed B operand).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

// ----------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda: taken through the runtime's
// entry-point query so the library needs no -lcuda.
static inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess && p != nullptr)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A bf16 tensor [outer, rows, cols] (row-major, contiguous) as a 3-D map
// {cols, rows, outer} with boxes of {64, box_rows, 1}, 128-byte swizzled.
// A box that runs past `rows` is zero-filled inside its own outer index, so
// a tile at a ragged edge never reads the next head.  Returns 0 or a
// cudaError_t.
static inline int make_tmap_bf16(CUtensorMap* map, const void* base,
                                 uint64_t cols, uint64_t rows,
                                 uint64_t outer, uint32_t box_rows) {
  // The driver encodes against the calling thread's current context, which
  // the runtime binds only at a thread's first call that needs it: on
  // autograd's device thread the backward can come first and the encode
  // would fail.  cudaFree(nullptr) binds it and frees nothing.
  static thread_local bool bound = false;
  if (!bound) {
    const cudaError_t err = cudaFree(nullptr);
    if (err != cudaSuccess) return (int)err;
    bound = true;
  }
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {cols, rows, outer};
  const cuuint64_t strides[2] = {cols * 2, rows * cols * 2};  // bytes
  const cuuint32_t box[3] = {64, box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// --------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory; completion (the box's
// full bytes, zero-filled part included) is counted on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from device memory into shared memory by the bulk copy engine,
// no tensor map; completion is counted on `bar` as for a TMA load.
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before later ones of
// the async proxy (bulk copies, TMA): a stage read by threads is refilled
// by a copy only after this fence.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `n` threads: wait for
// all n, or arrive without waiting.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Warpgroup register reallocation: every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address >> 4 (bits 0-13), leading byte offset >> 4 (16-29), stride byte
// offset >> 4 (32-45), base offset 0 (the atoms are 1024-byte aligned),
// layout 1 = 128B swizzle (62-63).
//  K-major (rows of 64 K-values): SBO = 1024 (eight 128-byte rows), LBO
//    unused; stepping K by 16 adds 32 bytes to the start address.
//  MN-major (rows = K, 64 N-values each): SBO = 1024 (the next 8 K rows),
//    LBO = the bytes between two 64-column halves along N.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) = low half
  return *reinterpret_cast<uint32_t*>(&v);
}

#define RT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RT_F16(d, i) RT_F4(d, i), RT_F4(d, i + 4), RT_F4(d, i + 8), \
                     RT_F4(d, i + 12)
#define RT_F32(d) RT_F16(d, 0), RT_F16(d, 16)
#define RT_F64(d) RT_F16(d, 0), RT_F16(d, 16), RT_F16(d, 32), RT_F16(d, 48)

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], bf16 in, fp32 accumulate; A
// and B K-major in shared memory.  Accumulator layout (per thread of the
// warpgroup; warp w, lane = 4 g + t): d[4 j + e] is row 16 w + g + 8 (e/2),
// column 8 j + 2 t + e % 2.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RT_F64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with N = 64: d[4 j + e] is row 16 w + g + 8 (e/2), column
// 8 j + 2 t + e % 2, j < 8.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_F32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A from registers (the bf16
// A-fragment of mma.m16n8k16 on each warp's 16 rows: a[0] row g columns
// 2t, 2t+1; a[1] row g+8; a[2] row g columns 2t+8, 2t+9; a[3] row g+8),
// B MN-major in shared memory (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, "
      "p, 1, 1, 1;\n}\n"
      : RT_F64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The same with N = 64.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RT_F32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db, accumulate);
  } else {
    static_assert(N == 64, "wgmma_rs: N in {64, 128}");
    wgmma_rs_n64(d, a, db, accumulate);
  }
}

// wgmma accumulator layout (N = 64 or 128): element i of a thread of warp
// `warp` (lane = 4 g + t) is row 16 warp + g + 8 ((i % 4) / 2), column
// 8 (i / 4) + 2 t + i % 2 of the 64-row tile.
__device__ __forceinline__ int acc_row(int i, int warp, int g) {
  return 16 * warp + g + 8 * ((i & 3) >> 1);
}
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// 64 x N fp32 accumulator (NA = N / 2 floats a thread) -> bf16 A fragments
// of N / 16 k16 steps: the accumulator's column blocks 2 kk and 2 kk + 1
// are the A fragment's columns 0-7 and 8-15 of step kk.
template <int NA>
__device__ __forceinline__ void acc_to_a(const float (&s)[NA],
                                         uint32_t (&a)[NA / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NA / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16x2(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

#undef RT_F4
#undef RT_F16
#undef RT_F32
#undef RT_F64

}  // namespace sm90
