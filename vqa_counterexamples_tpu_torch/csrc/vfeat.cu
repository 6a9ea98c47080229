// Candidate image features with the gather inside the kernel, forward and
// backward (see ops/cuda/vfeat_kernel.py).  GEMM rows are the B*K
// (example, candidate) pairs, row m = b*K + k, with x_m = table[idx[b,
// k+1]], o_m = table[idx[b, 0]] and m_m = bf16(o_m * x_m), all gathered or
// formed on chip.
//
// Both kernels are warp-specialized: a CTA is one producer warpgroup and
// two consumer warpgroups.  The producer (88 registers a thread) gathers
// the rows by cp.async, starts the TMA loads of the dense operand, forms
// bf16(o * x) into the stage once its rows land, and marks the stage full
// on an mbarrier; the consumers (208 registers, two sets of 76 f32
// accumulators a thread) run both products of a stage on wgmma
// m64n152k16 and release it on another mbarrier.  The copies, the
// products and the m formation of different stages overlap; the producer
// waits on the tensor cores only for a stage to refill.
//
// Forward (one launch; a CTA per 128-row tile and 152-column half of H):
//   h[m, n]  = bf16(f32(bf16(x_m . Wo[n])) + f32(bf16(m_m . Wm[n])))
//   dist[m]  = sqrt(sum_d (o_m[d] - x_m[d] + 1e-6)^2)        (f32)
// Consumer w owns rows 64 w .. 64 w + 63 over the CTA's 152 columns, both
// operands K-major, 128B-swizzled.  A stage is a 64-deep chunk of dim_v:
// the 128 gathered x rows, the tile's few distinct o rows (ceil(127 / K)
// + 1 at most: 7 at K 24, not one per row), the Wo / Wm slices (152 rows
// each, zeros past H; by TMA, or by cp.async where dim_v is off TMA's
// 16-byte strides) and the m rows.  The producer of column half b also
// adds the f32 squared differences of the 64-row block b, each thread over
// fixed (row, 8-column) cells in column order.  The consumers' epilogue
// rounds each product, sums, rounds again, stages the rows in shared
// memory and stores them whole.
//
// Backward (one launch of clusters; a cluster per 64 (d) x 304 (h) tile of
// both weight gradients, its CL CTAs splitting the rows):
//   dWo[h, d] = sum_m g[m, h] x_m[d],  dWm[h, d] = sum_m g[m, h] m_m[d]
// computed transposed, dW^T (d x h) = x^T g, with both operands MN-major
// as they lie (x and m rows: d contiguous; g rows: h contiguous): consumer
// w owns h 152 w .. 152 w + 151 of the tile, so that each x row is
// gathered and each m formed once for all of H.  A stage is a 64-row
// chunk: the gathered x rows (64 d), the chunk's distinct o rows, their
// table rows fetched a stage ahead, the g rows by TMA (three 64-wide h
// blocks 8192 bytes apart, LBO, for each half; the halves' blocks overlap
// by 40 columns, so that each starts on a block; the wrapper pads g's rows
// to 16 bytes where H needs it) and the m rows.  At the end each CTA
// stages its f32 partials in shared memory and the cluster sums them
// through distributed shared memory in rank order, each CTA a share of the
// tile's rows: no partial reaches device memory, no float atomics, reruns
// are bit-equal.
//
// Gathers are 16-byte copies where a row allows it (dim_v a multiple of 8,
// a 16-byte aligned base), else 4-byte ones; widths are even (the wrapper
// raises otherwise).
#include "common.cuh"

namespace vqacx {
namespace {

constexpr int NT = 384;               // a producer and two consumer WGs
constexpr int PT = 128;               // producer threads
constexpr int P_REGS = 88;            // registers a producer thread keeps
constexpr int C_REGS = 208;           // and a consumer thread takes
static_assert(PT * P_REGS + 2 * 128 * C_REGS <= 65536 / NT / 8 * 8 * NT,
              "the register split fits the launch's registers");
constexpr int BN = 152;               // wgmma N: forward columns, backward h
constexpr int ACC = BN / 2;           // f32 accumulators a thread per product
constexpr int BLK = 8192;             // a 64 x 64 bf16 block, 128B-swizzled
constexpr float DIST_EPS = 1e-6f;

__host__ __device__ constexpr int round1024(int b) {
  return (b + 1023) / 1024 * 1024;
}

__device__ __forceinline__ int clip(int i, int n) {
  return min(max(i, 0), n - 1);
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// The producer warpgroup's threads meet (named barrier 1).
__device__ __forceinline__ void producer_sync() { named_sync<1, PT>(); }

// The two consumer warpgroups meet (named barrier 2).
__device__ __forceinline__ void consumer_sync() { named_sync<2, 256>(); }

// Copy ``rows`` gathered rows, columns [c0, c0 + 64 NBLK) (zeros from
// ``ncols`` on, and for a row_of(r) < 0), into NBLK 64-wide 128B-swizzled
// blocks ``blk`` bytes apart (row r of a block at r * 128 bytes); the
// producer's threads.  VEC 8: 16-byte cp.async copies (ld, c0 and ncols
// multiples of 8, a 16-byte aligned base); 2: 4-byte copies (even, a
// 4-byte aligned base).
template <int VEC>
__device__ __forceinline__ void copy_piece(unsigned char* tile, int blk,
                                           const bf16* __restrict__ base,
                                           int ld, int i, int row, int c0,
                                           int ncols, int nblk) {
  constexpr int PER = 64 / VEC;
  const int r = i / (nblk * PER), b = (i / PER) % nblk;
  const int c = (i % PER) * VEC, col = c0 + 64 * b + c;
  const bool ok = row >= 0 && col < ncols;
  const bf16* src = ok ? base + (size_t)row * ld + col : base;
  unsigned char* dst = tile + b * blk + swizzled<128>(r, c);
  if constexpr (VEC == 8)
    cp_async16(dst, src, ok ? 16 : 0);
  else
    cp_async4(dst, src, ok ? 4 : 0);
}

template <int VEC, int NBLK, typename RowFn>
__device__ __forceinline__ void gather(unsigned char* tile, int blk,
                                       const bf16* __restrict__ base, int ld,
                                       int rows, int c0, int ncols,
                                       RowFn row_of) {
  static_assert(VEC == 2 || VEC == 8, "4- or 16-byte copies");
  constexpr int PER = 64 / VEC;
  for (int i = threadIdx.x; i < rows * NBLK * PER; i += PT)
    copy_piece<VEC>(tile, blk, base, ld, i, row_of(i / (NBLK * PER)), c0,
                    ncols, NBLK);
}

// The same for a fixed ROWS: with 16-byte copies every row index this
// thread needs is read before its first copy goes out.
template <int VEC, int NBLK, int ROWS, typename RowFn>
__device__ __forceinline__ void gather_fixed(unsigned char* tile, int blk,
                                             const bf16* __restrict__ base,
                                             int ld, int c0, int ncols,
                                             RowFn row_of) {
  if constexpr (VEC != 8) {
    gather<VEC, NBLK>(tile, blk, base, ld, ROWS, c0, ncols, row_of);
  } else {
    constexpr int N = ROWS * NBLK * 8 / PT;
    static_assert(ROWS * NBLK * 8 % PT == 0, "whole rounds of copies");
    int row[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      row[j] = row_of((threadIdx.x + j * PT) / (NBLK * 8));
#pragma unroll
    for (int j = 0; j < N; ++j)
      copy_piece<8>(tile, blk, base, ld, threadIdx.x + j * PT, row[j], c0,
                    ncols, NBLK);
  }
}

// m = bf16(o * x) over one 64-row x 64-column block (x at xb, o rows at
// ob, m to mb, all 128B-swizzled): producer thread l takes rows l / 8 +
// 16 u, 16-byte chunk l % 8; o_of(r) is row r's o row.  The bf16 pair
// multiply rounds the exact product once, as f32 then bf16 does.  With
// DIST it adds (o - x + 1e-6)^2 of its cells, columns below kv, to d[u]
// in column order.
template <bool DIST, typename OFn>
__device__ __forceinline__ void form_m(unsigned char* mb,
                                       const unsigned char* xb,
                                       const unsigned char* ob, OFn o_of,
                                       int kv, float (&d)[4]) {
  const int l = threadIdx.x, q = l % 8;
  Pack8 xv[4], ov[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = l / 8 + 16 * u;
    xv[u].u = *reinterpret_cast<const uint4*>(xb + swizzled<128>(r, 8 * q));
    ov[u].u = *reinterpret_cast<const uint4*>(ob + swizzled<128>(o_of(r),
                                                                 8 * q));
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    Pack8 mv;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      set_pair8(mv, k, __hmul2(pair8(ov[u], k), pair8(xv[u], k)));
    *reinterpret_cast<uint4*>(mb + swizzled<128>(l / 8 + 16 * u, 8 * q)) =
        mv.u;
  }
  if constexpr (DIST) {
    const int n = min(max(kv - 8 * q, 0), 8);   // this cell's columns
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float t =
            f32(lane8(ov[u], e)) - f32(lane8(xv[u], e)) + DIST_EPS;
        if (e < n) d[u] += t * t;
      }
  }
}

// acc_x (64 x 152) += X (64 x 64) Bx (64 x 152)^T and acc_m += Mt Bm^T
// over one 64-deep chunk, one commit group, both operands K-major (T 0:
// gmma_desc, +2 a k16 step) or MN-major (1: gmma_desc_mn, +128 a k16
// step; B's 64-wide blocks 8192 bytes apart); ``first`` overwrites.
template <int T>
__device__ __forceinline__ void mma_pair(float (&acc_x)[ACC],
                                         float (&acc_m)[ACC],
                                         const unsigned char* ax,
                                         const unsigned char* am,
                                         const unsigned char* bx,
                                         const unsigned char* bm,
                                         bool first) {
  fence_acc(acc_x);
  fence_acc(acc_m);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (T == 0)
      wgmma_bf16_ss<BN>(acc_x, gmma_desc<128>(ax) + 2 * kk,
                        gmma_desc<128>(bx) + 2 * kk, !first || kk > 0);
    else
      wgmma_bf16_ss<BN, 1, 1>(acc_x, gmma_desc_mn(ax) + 128 * kk,
                              gmma_desc_mn(bx, BLK) + 128 * kk,
                              !first || kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if constexpr (T == 0)
      wgmma_bf16_ss<BN>(acc_m, gmma_desc<128>(am) + 2 * kk,
                        gmma_desc<128>(bm) + 2 * kk, !first || kk > 0);
    else
      wgmma_bf16_ss<BN, 1, 1>(acc_m, gmma_desc_mn(am) + 128 * kk,
                              gmma_desc_mn(bm, BLK) + 128 * kk,
                              !first || kk > 0);
  }
  wgmma_commit();
}

// The consumers' loop over ``n`` stages of a ring of S: wait for stage
// it's full barrier, release the stage before it (its products are done),
// run both products on stage it (the operands at ``ops(st)``).
template <int T, typename OpsFn>
__device__ __forceinline__ void consume(float (&acc_x)[ACC],
                                        float (&acc_m)[ACC],
                                        unsigned char* ring, int stage,
                                        int S, int n, uint64_t* full,
                                        uint64_t* empty, OpsFn ops) {
  for (int it = 0; it < n; ++it) {
    const unsigned char* st = ring + (it % S) * stage;
    mbar_wait(full + it % S, (it / S) & 1);
    const unsigned char* ax;
    const unsigned char* am;
    const unsigned char* bx;
    const unsigned char* bm;
    ops(st, ax, am, bx, bm);
    wgmma_wait<0>();   // the products of stage it - 1 are done
    if (it > 0 && threadIdx.x % 128 == 0) mbar_arrive(empty + (it - 1) % S);
    mma_pair<T>(acc_x, acc_m, ax, am, bx, bm, it == 0);
  }
  wgmma_wait<0>();
  fence_acc(acc_x);
  fence_acc(acc_m);
}

// ---------------------------------------------------------------- forward

constexpr int F_BM = 128;             // rows per CTA: two consumers of 64
constexpr int F_XT = F_BM * 128;      // x (or m): 128 rows x 64 of dim_v
constexpr int F_WT = BN * 128;        // a weight slice: 152 rows x 64

// A stage: x, m, Wo, Wm, then the o rows.
__host__ __device__ constexpr int fwd_stage(int n_o) {
  return 2 * F_XT + 2 * F_WT + round1024(n_o * 128);
}

// Shared memory (bytes, with the 1024-byte alignment slack): the ring, the
// x and o row indices, the full and empty mbarriers.
__host__ __device__ constexpr int fwd_bytes(int n_o, int stages) {
  return 1024 + stages * fwd_stage(n_o) + ((2 * F_BM + n_o) * 4 + 7) / 8 * 8 +
         2 * stages * 8;
}

struct FwdParams {
  const bf16* table;   // (N, Dv)
  const int* idx;      // (B, K + 1)
  const bf16* wo;      // (H, Dv)
  const bf16* wm;      // (H, Dv)
  bf16* h;             // (B K, H)
  float* dist;         // (B K,)
  int N, Dv, B, K, H;
  int n_o;             // o rows a stage holds (the plan's)
  int stages;          // the ring's depth (the plan's)
};

// TMA: the weight slices by TMA (tmo / tmm: boxes of 64 x 152), else by
// cp.async (``load_box``).
template <int VEC, bool TMA>
__global__ void __launch_bounds__(NT, 1)
vfeat_fwd_kernel(const __grid_constant__ CUtensorMap tmo,
                 const __grid_constant__ CUtensorMap tmm,
                 const FwdParams p) {
  extern __shared__ unsigned char fdyn[];
  unsigned char* ring = fdyn + ((1024 - (smem_u32(fdyn) & 1023)) & 1023);
  const int S = p.stages, STAGE = fwd_stage(p.n_o);
  int* xrow = reinterpret_cast<int*>(ring + S * STAGE);
  int* oslot = xrow + F_BM;     // row r's o row in a stage
  int* orow = oslot + F_BM;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + S * STAGE + ((2 * F_BM + p.n_o) * 4 + 7) / 8 * 8);
  uint64_t* empty = full + S;
  const int M = p.B * p.K;
  // a row tile's column halves are neighbours in the grid: the second
  // finds the gathered rows in L2 when the table is beyond it
  const int CT = (p.H + BN - 1) / BN;
  const int r0 = (blockIdx.x / CT) * F_BM, n0 = (blockIdx.x % CT) * BN;
  const int b_lo = r0 / p.K;
  const int n_ex = (min(M, r0 + F_BM) - 1) / p.K - b_lo + 1;
  // clip like the reference gathers (indices are in range by
  // construction; this only keeps a bad index from faulting)
  for (int r = threadIdx.x; r < F_BM; r += NT) {
    const int m = r0 + r;
    xrow[r] = m < M ? clip(p.idx[(size_t)(m / p.K) * (p.K + 1) + 1 +
                                 m % p.K], p.N)
                    : -1;
    oslot[r] = max(min(m / p.K - b_lo, n_ex - 1), 0);
  }
  for (int j = threadIdx.x; j < p.n_o; j += NT)
    orow[j] = j < n_ex ? clip(p.idx[(size_t)(b_lo + j) * (p.K + 1)], p.N)
                       : -1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, PT + 1);   // the producer's threads, the weights
      mbar_init(empty + s, 2);       // the consumers
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int KC = (p.Dv + 63) / 64;

  if (threadIdx.x < PT) {
    // ---- the producer
    reg_dealloc<P_REGS>();
    auto load = [&](int c) {
      if (c < KC) {
        unsigned char* st = ring + (c % S) * STAGE;
        const int k0 = c * 64;
        gather_fixed<VEC, 1, F_BM>(st, 0, p.table, p.Dv, k0, p.Dv,
                                   [&](int r) { return xrow[r]; });
        gather<VEC, 1>(st + 2 * F_XT + 2 * F_WT, 0, p.table, p.Dv, p.n_o,
                       k0, p.Dv, [&](int j) { return orow[j]; });
        if constexpr (TMA) {
          if (threadIdx.x == 0) {
            mbar_arrive_expect_tx(full + c % S, 2 * F_WT);
            tma_load_2d(st + 2 * F_XT, &tmo, full + c % S, k0, n0);
            tma_load_2d(st + 2 * F_XT + F_WT, &tmm, full + c % S, k0, n0);
          }
        } else {
          load_box<VEC, PT>(st + 2 * F_XT, p.wo, p.Dv, n0, p.H, k0, p.Dv,
                            BN);
          load_box<VEC, PT>(st + 2 * F_XT + F_WT, p.wm, p.Dv, n0, p.H, k0,
                            p.Dv, BN);
          if (threadIdx.x == 0) mbar_arrive(full + c % S);
        }
      }
      cp_async_commit();
    };
    // the distance of block b's 64 rows is column half b's (both halves
    // gather the same rows), so that the halves' producers share the work
    auto with_dist = [&](int b) { return b % CT == n0 / BN; };
    float dp[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int c = 0; c < S - 1; ++c) load(c);
    for (int c = 0; c < KC; ++c) {
      cp_async_wait_upto(S - 2);   // this thread's copies of chunk c
      producer_sync();   // everyone's; everyone is done with chunk c - 1
      unsigned char* st = ring + (c % S) * STAGE;
      const unsigned char* os = st + 2 * F_XT + 2 * F_WT;
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        auto o_of = [&](int r) { return oslot[64 * b + r]; };
        if (with_dist(b))
          form_m<true>(st + F_XT + b * BLK, st + b * BLK, os, o_of,
                       p.Dv - 64 * c, dp[b]);
        else
          form_m<false>(st + F_XT + b * BLK, st + b * BLK, os, o_of, 0,
                        dp[b]);
      }
      fence_proxy_async();   // m, and the landed copies, to wgmma
      mbar_arrive(full + c % S);
      // chunk c + S - 1 goes into the stage of chunk c - 1 once the
      // consumers release it (they do as chunk c's products run)
      if (c > 0 && c + S - 1 < KC)
        mbar_wait(empty + (c - 1) % S, ((c - 1) / S) & 1);
      load(c + S - 1);
    }
    // the 8 threads of a row are 8 consecutive lanes: a fixed tree
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      if (!with_dist(b)) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float s = dp[b][u];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        const int m = r0 + 64 * b + threadIdx.x / 8 + 16 * u;
        if (threadIdx.x % 8 == 0 && m < M) p.dist[m] = sqrtf(s);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63
  reg_alloc<C_REGS>();
  const int cw = threadIdx.x / 128 - 1;
  float acc_o[ACC], acc_m[ACC];
  consume<0>(acc_o, acc_m, ring, STAGE, S, KC, full, empty,
             [&](const unsigned char* st, const unsigned char*& ax,
                 const unsigned char*& am, const unsigned char*& bx,
                 const unsigned char*& bm) {
               ax = st + cw * BLK;
               am = st + F_XT + cw * BLK;
               bx = st + 2 * F_XT;
               bm = st + 2 * F_XT + F_WT;
             });
  consumer_sync();   // every product is done: the ring is free

  // h = bf16(f32(bf16(acc_o)) + f32(bf16(acc_m))): each product rounds on
  // its own, then the sum rounds again
  bf16* hs = reinterpret_cast<bf16*>(ring);   // [128][BN]
  const int t = threadIdx.x - PT;             // 0 .. 255
  const int warp = t / 32, lane = t % 32;
  const int qrow = 16 * warp + lane / 4;      // 64 cw + 16 (warp % 4) + ..
  const int qcol = 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = 4 * i + 2 * hh;
      __nv_bfloat162 pr;
      pr.x = rn(f32(rn(acc_o[e])) + f32(rn(acc_m[e])));
      pr.y = rn(f32(rn(acc_o[e + 1])) + f32(rn(acc_m[e + 1])));
      *reinterpret_cast<__nv_bfloat162*>(hs + (qrow + 8 * hh) * BN + 8 * i +
                                         qcol) = pr;
    }
  consumer_sync();
  // whole rows out: the CTA's columns of a row are contiguous (4-byte
  // words: H is even, so every row and column pair is 4-byte aligned)
  const int ncol = min(BN, p.H - n0);
  for (int i = t; i < F_BM * (BN / 2); i += 256) {
    const int r = i / (BN / 2), c = 2 * (i % (BN / 2));
    if (r0 + r >= M || c >= ncol) continue;
    bf16* q = p.h + (size_t)(r0 + r) * p.H + n0 + c;
    const __nv_bfloat162 pr =
        *reinterpret_cast<const __nv_bfloat162*>(hs + r * BN + c);
    if (c + 1 < ncol)
      *reinterpret_cast<__nv_bfloat162*>(q) = pr;
    else
      q[0] = pr.x;
  }
}

// --------------------------------------------------------------- backward

constexpr int B_BD = 64;              // d per CTA
constexpr int B_BH = 2 * BN;          // h per CTA: a half per consumer
constexpr int B_BR = 64;              // rows per chunk (the products' K)
constexpr int B_GT = 6 * BLK;         // g: three 64-wide h blocks a half
constexpr int B_LDP = B_BD + 4;       // f32 row stride of a staged partial
constexpr int B_PART = 2 * B_BH * B_LDP * 4;   // both partials, [2][h][d]

// The o rows: n_o rows of 64 d.
__host__ __device__ constexpr int bwd_oblk(int n_o) {
  return round1024(n_o * 128);
}

// A stage: x, m (a 64 x 64 block each), g, the o rows, then its rows' o
// rows (64 ints).
__host__ __device__ constexpr int bwd_stage(int n_o) {
  return round1024(2 * BLK + B_GT + bwd_oblk(n_o) + B_BR * 4);
}

__host__ __device__ constexpr int bwd_ring(int n_o, int stages) {
  return round1024(stages * bwd_stage(n_o) > B_PART
                       ? stages * bwd_stage(n_o)
                       : B_PART);
}

// Shared memory (bytes, with the 1024-byte alignment slack): the ring (also
// the partials' staging at the end), two slots of row indices (x, o and
// each row's o row), the full and empty mbarriers.
__host__ __device__ constexpr int bwd_bytes(int n_o, int stages) {
  return 1024 + bwd_ring(n_o, stages) + 2 * 192 * 4 + 2 * stages * 8;
}

struct BwdParams {
  const bf16* table;   // (N, Dv)
  const int* idx;      // (B, K + 1)
  float* dwo;          // (H, Dv)
  float* dwm;          // (H, Dv)
  int N, Dv, B, K, H;
  int n_o;             // o rows a stage holds
  int cl;              // CTAs a cluster: row splits
  int stages;
};

// tmg: g (B K rows, row stride a multiple of 8) in boxes of 64 h x 64 rows.
template <int VX>
__global__ void __launch_bounds__(NT, 1)
vfeat_bwd_kernel(const __grid_constant__ CUtensorMap tmg, const BwdParams p) {
  extern __shared__ unsigned char bdyn[];
  unsigned char* ring = bdyn + ((1024 - (smem_u32(bdyn) & 1023)) & 1023);
  const int S = p.stages, STAGE = bwd_stage(p.n_o);
  int* islot = reinterpret_cast<int*>(ring + bwd_ring(p.n_o, S));  // [2][192]
  uint64_t* full = reinterpret_cast<uint64_t*>(islot + 2 * 192);
  uint64_t* empty = full + S;
  const unsigned rank = blockIdx.x % p.cl;
  const int tile = blockIdx.x / p.cl;
  const int DT = (p.Dv + B_BD - 1) / B_BD;
  const int d0 = (tile % DT) * B_BD, h0 = (tile / DT) * B_BH;
  const int M = p.B * p.K;
  const int chunks = (M + B_BR - 1) / B_BR;
  const int c_lo = rank * chunks / p.cl;
  const int nit = (rank + 1) * chunks / p.cl - c_lo;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, PT + 1);   // the producer's threads, g's bytes
      mbar_init(empty + s, 2);       // the consumers
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < PT) {
    // ---- the producer
    reg_dealloc<P_REGS>();
    // A chunk's table rows go through two slots of shared memory, fetched
    // a chunk ahead (thread t < 64: x row t and its o row in the stage;
    // 64 <= t < 64 + n_o: o row t - 64), so that no copy waits on an
    // index load.
    struct Rows {
      int row, slot;
    };
    auto fetch = [&](int it) -> Rows {
      const int t = threadIdx.x;
      if (it >= nit || t >= 64 + p.n_o) return {-1, 0};
      const int m0 = (c_lo + it) * B_BR, b_lo = m0 / p.K;
      const int n_ex = (min(M, m0 + B_BR) - 1) / p.K - b_lo + 1;
      if (t < 64) {
        const int m = m0 + t;
        return {m < M ? clip(p.idx[(size_t)(m / p.K) * (p.K + 1) + 1 +
                                   m % p.K], p.N)
                      : -1,
                max(min(m / p.K - b_lo, n_ex - 1), 0)};
      }
      const int j = t - 64;
      return {j < n_ex ? clip(p.idx[(size_t)(b_lo + j) * (p.K + 1)], p.N)
                       : -1,
              0};
    };
    auto put = [&](int it, Rows v) {
      islot[(it & 1) * 192 + threadIdx.x] = v.row;
      if (threadIdx.x < 64) islot[(it & 1) * 192 + 128 + threadIdx.x] = v.slot;
    };
    auto load = [&](int it) {
      if (it < nit) {
        unsigned char* st = ring + (it % S) * STAGE;
        const int* ix = islot + (it & 1) * 192;
        gather_fixed<VX, 1, B_BR>(st, 0, p.table, p.Dv, d0, p.Dv,
                                  [&](int r) { return ix[r]; });
        if (threadIdx.x < 64)   // the rows' o rows, for form_m
          reinterpret_cast<int*>(st + STAGE - B_BR * 4)[threadIdx.x] =
              ix[128 + threadIdx.x];
        gather<VX, 1>(st + 2 * BLK + B_GT, 0, p.table, p.Dv, p.n_o, d0,
                      p.Dv, [&](int j) { return ix[64 + j]; });
        if (threadIdx.x == 0) {
          // half w's blocks start at h0 + 152 w (the halves share 40
          // columns, so that each starts on a block)
          mbar_arrive_expect_tx(full + it % S, B_GT);
#pragma unroll
          for (int b = 0; b < 6; ++b)
            tma_load_2d(st + 2 * BLK + b * BLK, &tmg, full + it % S,
                        h0 + BN * (b / 3) + 64 * (b % 3), (c_lo + it) * B_BR);
        }
      }
      cp_async_commit();
    };
    float unused[4];
    for (int it = 0; it < S - 1; ++it) {
      put(it, fetch(it));
      producer_sync();
      load(it);
    }
    put(S - 1, fetch(S - 1));   // the loop's first load
    for (int it = 0; it < nit; ++it) {
      cp_async_wait_upto(S - 2);   // this thread's copies of chunk it
      producer_sync();   // everyone's; everyone is done with chunk it - 1
      const Rows next = fetch(it + S);   // lands while this chunk is formed
      unsigned char* st = ring + (it % S) * STAGE;
      const int* os = reinterpret_cast<const int*>(st + STAGE - B_BR * 4);
      auto o_of = [&](int r) { return os[r]; };
      form_m<false>(st + BLK, st, st + 2 * BLK + B_GT, o_of, 0, unused);
      fence_proxy_async();   // m, and the landed copies, to wgmma
      mbar_arrive(full + it % S);
      // chunk it + S - 1 goes into the stage of chunk it - 1 once the
      // consumers release it (they do as chunk it's products run)
      if (it > 0 && it + S - 1 < nit)
        mbar_wait(empty + (it - 1) % S, ((it - 1) / S) & 1);
      load(it + S - 1);
      put(it + S, next);   // the slot load(it + S - 2) read before the barrier
    }
    return;
  }

  // ---- the consumers: warpgroup cw owns h 152 cw .. 152 cw + 151
  reg_alloc<C_REGS>();
  const int cw = threadIdx.x / 128 - 1;
  float acc_o[ACC], acc_m[ACC];
  consume<1>(acc_o, acc_m, ring, STAGE, S, nit, full, empty,
             [&](const unsigned char* st, const unsigned char*& ax,
                 const unsigned char*& am, const unsigned char*& bx,
                 const unsigned char*& bm) {
               ax = st;
               am = st + BLK;
               bx = bm = st + 2 * BLK + 3 * cw * BLK;
             });
  consumer_sync();   // every product is done: the ring is free

  // the fragment holds dW^T: d rows qrow (+ 8), h columns 152 cw + 8 i +
  // qcol (+ 1)
  float* part = reinterpret_cast<float*>(ring);   // [2][B_BH][B_LDP]
  const int t = threadIdx.x - PT;                 // 0 .. 255
  const int lane = t % 32;
  const int qrow = 16 * (t / 32 % 4) + lane / 4;
  const int qcol = BN * cw + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * i + 2 * hh + c;
        const int at = (8 * i + qcol + c) * B_LDP + qrow + 8 * hh;
        part[at] = nit > 0 ? acc_o[e] : 0.0f;
        part[B_BH * B_LDP + at] = nit > 0 ? acc_m[e] : 0.0f;
      }
  cluster_sync();   // every split's partials are staged (the producers
                    // have left)
  // this CTA's h rows of the tile: the CL partials in rank order (all the
  // remote loads go out before the sum waits on any)
  const int HP = (B_BH + p.cl - 1) / p.cl;
  for (int i = t; i < 2 * HP * B_BD; i += 256) {
    const int sel = i / (HP * B_BD), hl = rank * HP + (i / B_BD) % HP;
    const int d = i % B_BD;
    if (hl >= B_BH) continue;   // the last CTA's rows end at B_BH
    const float* q = part + (sel * B_BH + hl) * B_LDP + d;
    float v[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      v[c] = c < p.cl ? ld_cluster_f32(q, c) : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < p.cl) s += v[c];
    if (h0 + hl < p.H && d0 + d < p.Dv)
      (sel ? p.dwm : p.dwo)[(size_t)(h0 + hl) * p.Dv + d0 + d] = s;
  }
  cluster_sync();   // no CTA leaves while another may still read it
}

cudaError_t set_smem(const void* k, size_t bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A launch of ``groups`` clusters of ``cl`` CTAs along x.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int groups, int cl, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(groups * cl);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// Shared memory of a CTA (bytes), for the wrapper's plans and their check.
extern "C" int vqacx_vfeat_fwd_smem(int n_o, int stages) {
  return vqacx::fwd_bytes(n_o, stages);
}

extern "C" int vqacx_vfeat_bwd_smem(int n_o, int stages) {
  return vqacx::bwd_bytes(n_o, stages);
}

// How many clusters of ``cl`` backward CTAs (``n_o``, ``stages``) the card
// holds at once (cudaOccupancyMaxActiveClusters), for the wrapper's plan;
// negative on an error.
extern "C" int vqacx_vfeat_bwd_clusters(int n_o, int cl, int stages) {
  using namespace vqacx;
  const void* k = reinterpret_cast<const void*>(vfeat_bwd_kernel<8>);
  const size_t smem = bwd_bytes(n_o, stages);
  if (set_smem(k, smem) != cudaSuccess) return -1;
  ClusterLaunch l(1, cl, smem, nullptr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, k, &l.cfg) == cudaSuccess ? n
                                                                      : -1;
}

// The forward (see the note at the top) with the wrapper's plan: ``n_o``
// o rows and ``stages`` ring stages.  Dv and H even, 4-byte aligned
// operands.
extern "C" int vqacx_vfeat_fwd(const void* table, int N, int Dv,
                               const void* idx, int B, int K, const void* wo,
                               const void* wm, int H, void* h_out,
                               void* dist_out, int n_o, int stages,
                               void* stream) {
  using namespace vqacx;
  if (B <= 0 || K <= 0 || N <= 0 || Dv <= 0 || H <= 0 || Dv % 2 || H % 2 ||
      n_o < 1 || n_o > F_BM || stages < 2 || stages > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const FwdParams p{static_cast<const bf16*>(table),
                    static_cast<const int*>(idx),
                    static_cast<const bf16*>(wo),
                    static_cast<const bf16*>(wm),
                    static_cast<bf16*>(h_out),
                    static_cast<float*>(dist_out), N, Dv, B, K, H, n_o,
                    stages};
  const bool tma = Dv % 8 == 0 && aligned16(table) && aligned16(wo) &&
                   aligned16(wm);
  CUtensorMap tmo{}, tmm{};
  if (tma) {
    const uint64_t dims[2] = {(uint64_t)Dv, (uint64_t)H};
    const uint32_t box[2] = {64, BN};
    if (!bf16_tensor_map(&tmo, wo, 2, dims, box, 128) ||
        !bf16_tensor_map(&tmm, wm, 2, dims, box, 128))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto k = tma ? vfeat_fwd_kernel<8, true> : vfeat_fwd_kernel<2, false>;
  const size_t smem = fwd_bytes(n_o, stages);
  cudaError_t rc = set_smem(reinterpret_cast<const void*>(k), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int grid = ((B * K + F_BM - 1) / F_BM) * ((H + BN - 1) / BN);
  k<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(tmo, tmm, p);
  return static_cast<int>(cudaGetLastError());
}

// The backward with the wrapper's plan: clusters of ``cl`` CTAs (row
// splits, 1 to 8), ``n_o`` o rows and ``stages`` ring stages.  g: (B K,
// ldg) bf16, ldg >= H a multiple of 8, 16-byte aligned.  dwo / dwm: f32
// (H, Dv) outputs.
extern "C" int vqacx_vfeat_bwd(const void* table, int N, int Dv,
                               const void* idx, int B, int K, const void* g,
                               int H, int ldg, void* dwo, void* dwm, int n_o,
                               int cl, int stages, void* stream) {
  using namespace vqacx;
  if (B <= 0 || K <= 0 || N <= 0 || Dv <= 0 || H <= 0 || Dv % 2 || H % 2 ||
      ldg < H || ldg % 8 || !aligned16(g) || n_o < 1 || n_o > B_BR ||
      cl < 1 || cl > 8 || stages < 2 || stages > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdParams p{static_cast<const bf16*>(table),
                    static_cast<const int*>(idx),
                    static_cast<float*>(dwo),
                    static_cast<float*>(dwm),
                    N, Dv, B, K, H, n_o, cl, stages};
  CUtensorMap tmg{};
  const uint64_t dims[2] = {(uint64_t)ldg, (uint64_t)B * K};
  const uint32_t box[2] = {64, B_BR};
  if (!bf16_tensor_map(&tmg, g, 2, dims, box, 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vx = Dv % 8 == 0 && aligned16(table);
  auto k = vx ? vfeat_bwd_kernel<8> : vfeat_bwd_kernel<2>;
  const size_t smem = bwd_bytes(n_o, stages);
  cudaError_t rc = set_smem(reinterpret_cast<const void*>(k), smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tiles = ((Dv + B_BD - 1) / B_BD) * ((H + B_BH - 1) / B_BH);
  ClusterLaunch l(tiles, cl, smem, static_cast<cudaStream_t>(stream));
  rc = cudaLaunchKernelEx(&l.cfg, k, tmg, p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
