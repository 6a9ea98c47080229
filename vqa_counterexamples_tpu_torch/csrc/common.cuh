// Shared helpers for the hand-written sm_90a kernels of this package.
//
// Every kernel here is a tiled GEMM with a fused epilogue: in the kNN
// kernel, mma.sync fed by a cp.async ring; in the GRU forward and
// backward and the mixture kernel, Hopper's wgmma fed by TMA through an
// mbarrier ring; in the vfeat forward and backward, the folded MUTAN
// forward and backward and the MUTAN Tucker kernel, wgmma (K- and
// MN-major operands) fed by a cp.async ring (``load_box`` and the vfeat
// row gathers), whose 4-byte copies take the rows of 310, 510, 600 and
// 620 elements or bytes that TMA's 16-byte strides refuse (16-byte copies
// where a row allows them).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vqacx {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }

// Round to nearest even, as XLA's f32 -> bf16 convert does.
__device__ __forceinline__ bf16 rn(float x) { return __float2bfloat16_rn(x); }

__device__ __forceinline__ bf16 bf16_zero() { return __ushort_as_bfloat16(0); }

// Eight bf16 values moved as one 16-byte word.  The lanes are read and
// written with shifts on the four 32-bit words, selected without
// indexing, so a Pack8 stays in registers even where e is not a constant
// (an indexed union would live in local memory).
struct Pack8 {
  uint4 u;
};

__device__ __forceinline__ unsigned word8(const Pack8& p, int i) {
  return i == 0 ? p.u.x : i == 1 ? p.u.y : i == 2 ? p.u.z : p.u.w;
}

__device__ __forceinline__ bf16 lane8(const Pack8& p, int e) {
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(word8(p, e >> 1) >> (16 * (e & 1))));
}

// Lanes 2 k and 2 k + 1 as a bf16 pair, and back.
__device__ __forceinline__ __nv_bfloat162 pair8(const Pack8& p, int k) {
  const unsigned w = word8(p, k);
  return *reinterpret_cast<const __nv_bfloat162*>(&w);
}

__device__ __forceinline__ void set_pair8(Pack8& p, int k,
                                          __nv_bfloat162 v) {
  const unsigned w = *reinterpret_cast<const unsigned*>(&v);
  switch (k) {
    case 0: p.u.x = w; break;
    case 1: p.u.y = w; break;
    case 2: p.u.z = w; break;
    default: p.u.w = w; break;
  }
}

__device__ __forceinline__ void set_lane8(Pack8& p, int e, bf16 v) {
  const unsigned sh = 16 * (e & 1);
  const unsigned x = (word8(p, e >> 1) & ~(0xffffu << sh)) |
                     (static_cast<unsigned>(__bfloat16_as_ushort(v)) << sh);
  switch (e >> 1) {
    case 0: p.u.x = x; break;
    case 1: p.u.y = x; break;
    case 2: p.u.z = x; break;
    default: p.u.w = x; break;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ------------------------------------------------ async copies, mma.sync
// (used by the kNN kernel and the wgmma kernels' cp.async rings)

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
// (used by the GRU forward and backward, the mixture kernel and the folded
// backward)

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

__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One TMA tile store, shared -> global, in the bulk group of this thread;
// the tile's layout is the map's (box and swizzle), out-of-bounds parts
// are not written.
__device__ __forceinline__ void tma_store_2d(const void* map, const void* src,
                                             int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until the committed stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Byte offset of bf16 element (r, k) in a tile of rows of RB bytes (RB =
// 32, 64 or 128) under the matching TMA swizzle (32B / 64B / 128B): the
// 16-byte chunk index is XORed with address bits 7 and up.  The tile's
// base must be 1024-byte aligned.
template <int RB>
__device__ __forceinline__ int swizzled(int r, int k) {
  const int o = r * RB + k * 2;
  return o ^ ((((o >> 7) & (RB / 16 - 1))) << 4);
}

// Wait until at most n (0 to 3) committed cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n >= 3) cp_async_wait<3>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 1) cp_async_wait<1>();
  else cp_async_wait<0>();
}

// Copy n bf16 from g to s (both 4-byte aligned when V4, n then even),
// zeros for [n, n_pad); threads tid0 .. tid0 + NTH - 1 of the block.
template <bool V4, int NTH>
__device__ __forceinline__ void load_row(bf16* s, const bf16* __restrict__ g,
                                         int n, int n_pad) {
  if constexpr (V4) {
    for (int c = 2 * (threadIdx.x % NTH); c < n_pad; c += 2 * NTH)
      cp_async4(s + c, c < n ? g + c : g, c < n ? 4 : 0);
  } else {
    for (int c = threadIdx.x % NTH; c < n_pad; c += NTH)
      s[c] = c < n ? g[c] : bf16_zero();
  }
}

// Copy a (rows x 64) bf16 box at (r0, c0) of a row-major (nrows, ncols)
// matrix, row stride ld, into a 128B-swizzled tile (row r at r * 128
// bytes; the layout of ``gmma_desc<128>``), zeros outside.  VEC 8:
// 16-byte cp.async copies (ld and ncols multiples of 8, c0 of 64, a
// 16-byte aligned base); 2: 4-byte copies (even widths, 4-byte aligned
// base); 1: plain loads.
template <int VEC, int NTH>
__device__ __forceinline__ void load_box(unsigned char* tile,
                                         const bf16* __restrict__ g, int ld,
                                         int r0, int nrows, int c0,
                                         int ncols, int rows) {
  static_assert(VEC == 1 || VEC == 2 || VEC == 8, "1, 2 or 8 elements");
  if constexpr (VEC > 1) {
    // thread t: the chunk of VEC columns (t % (64 / VEC)) of rows
    // t / (64 / VEC), + NTH / (64 / VEC), ..
    constexpr int PER_ROW = 64 / VEC, STEP = NTH / PER_ROW;
    const int t = threadIdx.x % NTH, c = (t % PER_ROW) * VEC;
    const bool cok = c0 + c < ncols;
    const bf16* src = g + (size_t)(r0 + t / PER_ROW) * ld + c0 + c;
    for (int r = t / PER_ROW; r < rows; r += STEP, src += (size_t)STEP * ld) {
      const bool ok = cok && r0 + r < nrows;
      if constexpr (VEC == 8)
        cp_async16(tile + swizzled<128>(r, c), ok ? src : g, ok ? 16 : 0);
      else
        cp_async4(tile + swizzled<128>(r, c), ok ? src : g, ok ? 4 : 0);
    }
  } else {
    for (int i = threadIdx.x % NTH; i < rows * 64; i += NTH) {
      const int r = i / 64, c = i % 64;
      *reinterpret_cast<bf16*>(tile + swizzled<128>(r, c)) =
          r0 + r < nrows && c0 + c < ncols
              ? g[(size_t)(r0 + r) * ld + c0 + c]
              : bf16_zero();
    }
  }
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

// wgmma shared-memory descriptor of an MN-major bf16 operand (the M or N
// index contiguous: TA / TB = 1 below) in the RB-byte swizzled layout
// (RB = 128, 64 or 32): rows of RB / 2 elements along M or N, one row per
// K index, 8 rows a swizzle atom of 8 RB bytes, as a TMA box of RB / 2 x
// rows with the RB-byte swizzle (or ``swizzled<RB>(k, mn)``) lays them
// out.  SBO (8 RB bytes) steps 8 K rows; LBO steps to the next RB / 2
// elements along M or N, so an operand wider than that keeps its column
// blocks ``lbo`` bytes apart (the vfeat backward's g tile: blocks of 64 K
// rows, 8192 bytes; the GRU backward's W: 16-unit chunks of 32 K rows,
// 1024 bytes); an operand one block wide never reads it.  Adding RB
// advances K by 16 (16 rows of RB bytes).
template <int RB = 128>
__device__ __forceinline__ uint64_t gmma_desc_mn(const void* smem,
                                                 int lbo = 1024) {
  static_assert(RB == 32 || RB == 64 || RB == 128, "32B, 64B or 128B");
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)((8 * RB) >> 4) << 32) |
         ((uint64_t)(RB == 128 ? 1 : RB == 64 ? 2 : 3) << 62);
}

// d (64 x N, f32, the warpgroup's fragment) += A (64 x 16) B (16 x N)^T,
// bf16, A and B in shared memory (descriptors a, b): K-major (TA / TB 0,
// gmma_desc) or MN-major (1, gmma_desc_mn).  scale_d 0 makes it d = A B^T
// (a tile's first product: zeroing d with other instructions instead
// makes ptxas serialize the wgmmas).  Fragment layout: thread t of
// the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and, in n8
// block i, columns 8 i + 2 (t % 4) (+ 1), at d[4 i + 2 h + c] for row half
// h and column c.
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_bf16_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int scale_d = 1) {
  static_assert(N == 8 || N == 40 || N == 48 || N == 64 || N == 80 ||
                    N == 128 || N == 152 || N == 160,
                "an instantiated wgmma width");
  if constexpr (false) {
  } else if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 40) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19"
        "}, %20, %21, p, 1, 1, %23, %24;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 48) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23"
        "}, %24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39"
        "}, %40, %41, p, 1, 1, %43, %44;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 152) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %78, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75"
        "}, %76, %77, p, 1, 1, %79, %80;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 160) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, %83, %84;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// ------------------------------------------------------------ clusters
// (the mixture kernel's CTA pairs, the folded backward's example groups)

// All non-exited threads of the cluster; release / acquire order the
// shared-memory accesses around it across the cluster's CTAs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The f32 at ``local``'s offset in the shared memory of the cluster's CTA
// ``rank`` (distributed shared memory).
__device__ __forceinline__ float ld_cluster_f32(const float* local,
                                                unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(remote)
               : "memory");
  return v;
}

// Threads [0, NTH) of the block (whole warps) meet at named barrier ID.
template <int ID, int NTH>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(NTH) : "memory");
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

// A tensor map over a bf16 array of ``rank`` (2 to 4) dimensions,
// innermost (contiguous) first, with ``strides`` the byte strides of
// dimensions 1 .. rank - 1 (multiples of 16, in any order), read in boxes
// of ``box``, swizzled for rows of ``swizzle`` bytes (32, 64 or 128);
// zeros outside the array.
inline bool bf16_tensor_map_strided(CUtensorMap* map, const void* base,
                                    int rank, const uint64_t* dims,
                                    const uint64_t* strides,
                                    const uint32_t* box, int swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || rank < 2 || rank > 4) return false;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i + 1 < rank) gstride[i] = strides[i];
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), gdim, gstride, bdim, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
            : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same over a contiguous row-major array (rank 2 or 3).
inline bool bf16_tensor_map(CUtensorMap* map, const void* base, int rank,
                            const uint64_t* dims, const uint32_t* box,
                            int swizzle) {
  uint64_t strides[2];
  uint64_t stride = 2;
  for (int i = 0; i + 1 < rank && i < 2; ++i) strides[i] = stride *= dims[i];
  return bf16_tensor_map_strided(map, base, rank, dims, strides, box,
                                 swizzle);
}

}  // namespace vqacx

// Every library exports this for the Python side's error messages.
#define VQACX_DEFINE_ERROR_STRING                                   \
  extern "C" const char* vqacx_error_string(int code) {             \
    return cudaGetErrorString(static_cast<cudaError_t>(code));      \
  }
