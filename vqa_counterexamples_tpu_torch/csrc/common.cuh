// Shared helpers for the hand-written sm_90a kernels of this package.
//
// Every kernel here is a tiled GEMM on bf16 WMMA fragments (16x16x16, f32
// accumulators) with a fused epilogue.  Operand tiles are staged in shared
// memory with a row stride of BK + 8 elements: the 16-byte pad staggers
// rows across banks and keeps every fragment pointer 32-byte aligned.
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

}  // namespace vqacx

// Every library exports this for the Python side's error messages.
#define VQACX_DEFINE_ERROR_STRING                                   \
  extern "C" const char* vqacx_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }
