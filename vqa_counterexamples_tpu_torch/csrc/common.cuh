// Shared helpers for the hand-written sm_90a kernels of this package.
//
// Every kernel here is a tiled GEMM with a fused epilogue: bf16 WMMA
// fragments (16x16x16, f32 accumulators) with synchronous tile loads, or,
// in the kNN and GRU-backward kernels, mma.sync fed by a cp.async ring.
// WMMA operand tiles are staged in shared memory with a row stride of
// BK + 8 elements: the 16-byte pad staggers rows across banks and keeps
// every fragment pointer 32-byte aligned.
#pragma once

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

}  // namespace vqacx

// Every library exports this for the Python side's error messages.
#define VQACX_DEFINE_ERROR_STRING                                   \
  extern "C" const char* vqacx_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }
