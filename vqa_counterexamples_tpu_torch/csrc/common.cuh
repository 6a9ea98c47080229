// Shared helpers for the hand-written sm_90a kernels of this package.
//
// Every kernel here is a tiled GEMM with a fused epilogue: bf16 WMMA
// fragments (16x16x16, f32 accumulators) with synchronous tile loads; in
// the kNN and GRU-backward kernels, mma.sync fed by a cp.async ring; in
// the GRU forward, Hopper's wgmma fed by TMA through an mbarrier ring.
// WMMA operand tiles are staged in shared memory with a row stride of
// BK + 8 elements: the 16-byte pad staggers rows across banks and keeps
// every fragment pointer 32-byte aligned.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace vqacx {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }

// Round to nearest even, as XLA's f32 -> bf16 convert does.
__device__ __forceinline__ bf16 rn(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ bf16 bf16_zero() { return __ushort_as_bfloat16(0); }

// Eight bf16 values moved as one 16-byte word.
union Pack8 {
  uint4 u;
  unsigned short s[8];
};

__device__ __forceinline__ bf16 lane8(const Pack8& p, int e) {
  return __ushort_as_bfloat16(p.s[e]);
}

__device__ __forceinline__ void set_lane8(Pack8& p, int e, bf16 v) {
  p.s[e] = __bfloat16_as_ushort(v);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Copy rows [row0, row0 + ROWS) x columns [k0, k0 + BK) of a row-major bf16
// matrix (nrows x ncols, row stride ld) into shared memory with row stride
// LDS, writing zeros outside the matrix.  ``vec`` allows 16-byte loads
// (ld % 8 == 0 and a 16-byte aligned base).
template <int ROWS, int BK, int LDS, int NT>
__device__ __forceinline__ void load_tile(bf16* __restrict__ s,
                                          const bf16* __restrict__ g, int ld,
                                          int row0, int nrows, int k0,
                                          int ncols, bool vec) {
  constexpr int CH = BK / 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
    const int r = c / CH;
    const int kc = (c % CH) * 8;
    const int gr = row0 + r;
    const int gk = k0 + kc;
    bf16* dst = s + r * LDS + kc;
    if (gr < nrows && vec && gk + 8 <= ncols) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + (size_t)gr * ld + gk);
    } else {
      for (int e = 0; e < 8; ++e) {
        dst[e] = (gr < nrows && gk + e < ncols) ? g[(size_t)gr * ld + gk + e]
                                                : bf16_zero();
      }
    }
  }
}

// ------------------------------------------------ async copies, mma.sync
// (used by the redesigned kNN and GRU-backward kernels)

// Copy 16 (or 4) bytes global -> shared without passing through registers;
// ``src_bytes`` 0 writes zeros (the source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start fetching the line holding ``p`` into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Four 8x8 b16 matrices from shared memory (lane l gives the row address
// of matrix l / 8), optionally transposed.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const unsigned (&a)[4],
                                               unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulators.
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const unsigned (&a)[4],
                                              unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// ------------------------------------------- Hopper: TMA, mbarrier, wgmma
// (used by the GRU forward)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// An mbarrier in shared memory that completes a phase after ``count``
// arrivals (and, with expect_tx, the bytes of the copies it tracks).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// After the inits, before any other thread or the TMA unit uses them.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the phase of parity ``parity`` (the n-th
// completion since init has parity n & 1).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Shared-memory writes of this thread become visible to the async proxy
// (wgmma, TMA) once the barrier that follows orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One TMA tile load, global -> shared, completing on ``bar``.  ``map``
// is a __grid_constant__ CUtensorMap kernel parameter; coordinates are
// element indices, innermost first.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Byte offset of bf16 element (r, k) in a K-major tile of rows of RB
// bytes (RB = 64 or 128) under the matching TMA swizzle (64B / 128B):
// the 16-byte chunk index is XORed with address bits 7 and up.  The
// tile's base must be 1024-byte aligned.
template <int RB>
__device__ __forceinline__ int swizzled(int r, int k) {
  const int o = r * RB + k * 2;
  return o ^ ((((o >> 7) & (RB / 16 - 1))) << 4);
}

// wgmma shared-memory descriptor of a K-major bf16 tile with rows of RB
// bytes, swizzled as above: start address, LBO (unused when swizzled),
// SBO = 8 rows, layout B128 (1) or B64 (2).  Adding 2 advances K by 16.
template <int RB>
__device__ __forceinline__ uint64_t gmma_desc(const void* smem) {
  static_assert(RB == 64 || RB == 128, "64B or 128B swizzle");
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)((8 * RB) >> 4) << 32) |
         ((uint64_t)(RB == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups of this warpgroup are in
// flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the
// asynchronous wgmma window.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, f32, the warpgroup's fragment) += A (64 x 16) B (16 x N)^T,
// bf16, A and B K-major in shared memory (descriptors a, b).  Fragment
// layout: thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// (+ 8) and, in n8 block i, columns 8 i + 2 (t % 4) (+ 1), at d[4 i + 2 h
// + c] for row half h and column c.
template <int N>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16_ss<40>(float (&d)[20], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19}, %20, %21, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16_ss<80>(float (&d)[40], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(1));
}

// cuTensorMapEncodeTiled reached through the runtime's driver entry point,
// so the library needs no link against libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over a contiguous row-major bf16 array of ``rank`` (2 or 3)
// dimensions, innermost first, read in boxes of ``box``, swizzled for
// rows of ``swizzle`` bytes (64 or 128); zeros outside the array.
inline bool bf16_tensor_map(CUtensorMap* map, const void* base, int rank,
                            const uint64_t* dims, const uint32_t* box,
                            int swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t gdim[3], gstride[2];
  cuuint32_t bdim[3], estride[3];
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = stride *= dims[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), gdim, gstride, bdim, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace vqacx

// Every library exports this for the Python side's error messages.
#define VQACX_DEFINE_ERROR_STRING                                   \
  extern "C" const char* vqacx_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }
