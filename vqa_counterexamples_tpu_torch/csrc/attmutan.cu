// The folded attention-MUTAN fusion, forward and backward (see
// ops/cuda/attmutan_kernel.py).  Per example b:
//   weff[d, m]   = bf16(sum_r w[r, m, d] * hq[b, r, m])        (f32 sum)
//   out[b, k, m] = bf16(x_v[b, k, :] @ weff[:, m]
//                       + sum_r b3[r, m] hq[b, r, m])
// w is the stacked per-rank Linear weight (R * M, Dh), row r * M + m; b3
// and hq arrive rounded to bf16, as the TPU kernel rounds them.  weff never
// reaches device memory: each block builds the slice it multiplies with in
// shared memory.
//
// Forward: a block owns one example and 64 output columns.  It builds its
// weff slice (all of Dh x 64 columns) once, then walks the positions in
// tiles of 64 rows, Dh in chunks of 64, on bf16 WMMA fragments with f32
// accumulators (4 warps, 2 x 2, four 16 x 16 fragments each).
//
// Backward, three launches, no atomics (reruns are bit-equal).  At
// MutanAtt's shape (B 128, K 196, Dh 310, R 5, M 510) the rows of x_v, g
// and w are 620 and 1020 bytes, off TMA's 16-byte strides, so every stage
// is filled by 4-byte cp.async copies into the 128B-swizzled layout wgmma
// reads (plain loads when a width is odd):
//   dx:    a CTA owns (example, 160 of Dh) over all K positions.  It builds
//          its weff slice once, in shared memory, rank by rank in f32 and
//          rounded once (K-major, 160 rows of d), while the first g stages
//          load; then two warpgroups stream g[b] (128 positions x 64 of M
//          a stage) through a cp.async ring into wgmma m64n160k16 and
//          store dx_v = bf16(acc) from the fragments.  Each example's weff
//          is built once in all.
//   dweff: a CTA owns (64 of M, 64 of Dh) for one of 8 contiguous groups
//          of examples, the 8 groups of a tile one cluster.  Per example
//          it runs dweff^T = g[b]^T x_v[b] (f32) on wgmma with both
//          operands MN-major, as the tiles arrive (positions x 64), the
//          ring running on across examples; then, in registers, dw[r] +=
//          dweff * hq[b, r] and this tile's part of dhq[b, r, m] = sum_d
//          w[r, m, d] dweff[d, m] (the thread's 16 d, then its quad by
//          shuffles); where the tile holds d = 0, an m64n8 wgmma against
//          a tile of ones also gives gsum[b, m] = sum_k g[b, k, m].  At the
//          end the 8 CTAs of a cluster add their dw partials through
//          distributed shared memory in group order, each CTA 8 of the 64
//          rows, and write dw: no partial reaches device memory.  Ranks go
//          5 at a time (one launch per 5: one at R 5).
//   finish: one thread per (b, m): dhq = bf16(the d tiles' partials in
//          order + b3 * gsum); one warp per (r, m): db = sum_b gsum * hq,
//          lanes over the examples, then a fixed shuffle tree.  dhq needs
//          every d tile and db every example, hence a launch of its own.
#include "common.cuh"

namespace vqacx {
namespace {

constexpr int NT = 128;
constexpr int T = 64;          // tile edge: positions, Dh and M
constexpr int LDS = T + 8;     // bf16 operand tiles
constexpr int LDC = T + 4;     // f32 result tile
constexpr int PER = T * T / NT;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

using namespace nvcuda;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                             wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 2 x 2 warps, each a 32 x 32 quarter of the 64 x 64 result tile.
__device__ __forceinline__ void zero(FragC (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
}

__device__ __forceinline__ void store(FragC (&acc)[2][2], float* Cs) {
  const int warp = threadIdx.x / 32;
  const int wm = warp % 2, wn = warp / 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
}

// ---------------------------------------------------------------- forward

__global__ void __launch_bounds__(NT)
attmutan_fwd_kernel(const bf16* __restrict__ xv,   // (B, K, Dh)
                    const bf16* __restrict__ w,    // (R * M, Dh)
                    const bf16* __restrict__ b3,   // (R, M)
                    const bf16* __restrict__ hq,   // (B, R, M)
                    bf16* __restrict__ out,        // (B, K, M)
                    int K, int Dh, int R, int M, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int DHP = round_up(Dh, T);
  const int LDW = DHP + 8;
  bf16* weffT = reinterpret_cast<bf16*>(smem);            // [T m][LDW d]
  bf16* xs = weffT + T * LDW;                              // [T k][LDS d]
  float* Cs = reinterpret_cast<float*>(xs + T * LDS);      // [T k][LDC m]
  float* hq_s = Cs + T * LDC;                              // [R][T m]
  float* bias_s = hq_s + R * T;                            // [T m]

  const int m0 = blockIdx.x * T;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < R * T; i += NT) {
    const int r = i / T, m = m0 + i % T;
    hq_s[i] = m < M ? f32(hq[((size_t)b * R + r) * M + m]) : 0.0f;
  }
  __syncthreads();
  for (int mm = threadIdx.x; mm < T; mm += NT) {
    float s = 0.0f;
    if (m0 + mm < M)
      for (int r = 0; r < R; ++r)
        s = s + __fmul_rn(f32(b3[(size_t)r * M + m0 + mm]), hq_s[r * T + mm]);
    bias_s[mm] = s;
  }
  // weff's slice, rounded to bf16; zero past Dh and M
  for (int i = threadIdx.x; i < T * DHP; i += NT) {
    const int mm = i / DHP, d = i % DHP;
    const int m = m0 + mm;
    float s = 0.0f;
    if (m < M && d < Dh)
      for (int r = 0; r < R; ++r)
        s = s + __fmul_rn(f32(w[((size_t)r * M + m) * Dh + d]),
                          hq_s[r * T + mm]);
    weffT[mm * LDW + d] = rn(s);
  }
  __syncthreads();

  const bf16* xb = xv + (size_t)b * K * Dh;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 2, wn = warp / 2;
  for (int k0 = 0; k0 < K; k0 += T) {
    FragC acc[2][2];
    zero(acc);
    for (int d0 = 0; d0 < DHP; d0 += T) {
      load_tile<T, T, LDS, NT>(xs, xb, Dh, k0, K, d0, Dh, vec);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < T; kk += 16) {
        FragA fa[2];
        FragBc fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], xs + (wm * 32 + i * 16) * LDS + kk,
                                 LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(
              fb[j], weffT + (wn * 32 + j * 16) * LDW + d0 + kk, LDW);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
    store(acc, Cs);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = threadIdx.x + e * NT;
      const int kk = i / T, mm = i % T;
      if (k0 + kk < K && m0 + mm < M)
        out[((size_t)b * K + k0 + kk) * M + m0 + mm] =
            rn(Cs[kk * LDC + mm] + bias_s[mm]);
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------- backward
// (wgmma, cp.async rings, clusters)

constexpr int XDS = 160;           // dx: Dh per CTA (wgmma N)
constexpr int XROWS = 128;         // dx: positions per stage (2 x 64)
constexpr int XCHUNK = XDS * 128;  // dx: one 64-wide M chunk of weff
constexpr int XSTAGE = XROWS * 128;
constexpr int XNT = 256;
constexpr int WRG = 5;             // dweff: ranks per launch
constexpr int WCL = 8;             // dweff: CTAs (example groups) a cluster
constexpr int WNT = 128;
constexpr int WSTAGE = 2 * 8192 + 1024;  // dweff: a g tile, an x_v tile
                                   // and the example's hq (R x 64 bf16)
constexpr int WSTAGES = 3;         // dweff: ring depth
constexpr int WLD = 72;            // dweff: row stride of the w tile and
                                   // of the staged dw partial (+ 8: the
                                   // fragment's rows hit other banks)
constexpr int WONES = 1024;        // dweff: 8 x 64 ones, K-major

// Shared memory (bytes, with the 1024-byte alignment slack).
__host__ __device__ constexpr int dx_bytes(int mc, int R, int stages) {
  return 1024 + mc * XCHUNK + stages * XSTAGE + R * mc * 64 * 2;
}
__host__ __device__ constexpr int dweff_bytes() {
  return 1024 + WSTAGES * WSTAGE + WONES + WRG * 64 * WLD * 2;
}
static_assert(WSTAGES * WSTAGE + WONES + WRG * 64 * WLD * 2 >=
                  WRG * 64 * WLD * 4,
              "the dw partial fits in the ring, the ones and the w tile");

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
// bytes), zeros outside.  V4: 4-byte cp.async copies (even widths, 4-byte
// aligned base), else plain loads.
template <bool V4, int NTH>
__device__ __forceinline__ void load_box(unsigned char* tile,
                                         const bf16* __restrict__ g, int ld,
                                         int r0, int nrows, int c0,
                                         int ncols, int rows) {
  if constexpr (V4) {
    // thread t: the column pair 2 (t % 32) of rows t / 32, + NTH / 32, ..
    const int t = threadIdx.x % NTH, c = (t % 32) * 2;
    const bool cok = c0 + c < ncols;
    const bf16* src = g + (size_t)(r0 + t / 32) * ld + c0 + c;
    for (int r = t / 32; r < rows; r += NTH / 32, src += (NTH / 32) * ld) {
      const bool ok = cok && r0 + r < nrows;
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

struct BwdParams {
  const bf16* xv;    // (B, K, Dh)
  const bf16* w;     // (R * M, Dh)
  const bf16* b3;    // (R, M)
  const bf16* hq;    // (B, R, M)
  const bf16* g;     // (B, K, M)
  bf16* dxv;         // (B, K, Dh)
  bf16* dhq;         // (B, R, M)
  float* dw;         // (R * M, Dh)
  float* db;         // (R, M)
  float* pdhq;       // (DT, B, R, M): the d tiles' parts of dhq
  float* gsum;       // (B, M)
  int B, K, Dh, R, M;
  int stages;
  int r0, nr;        // dweff: this launch's ranks
  int group[WCL + 1];   // dweff: CTA c of a cluster takes the examples
                        // [group[c], group[c + 1]) (the wrapper's plan)
};

// ------------------------------------------------------------ backward: dx

template <bool V4>
__global__ void __launch_bounds__(XNT, 1)
attmutan_bwd_dx_kernel(const BwdParams p) {
  extern __shared__ unsigned char xdyn[];
  unsigned char* weff = xdyn + ((1024 - (smem_u32(xdyn) & 1023)) & 1023);
  const int MC = (p.M + 63) / 64, S = p.stages;
  unsigned char* ring = weff + MC * XCHUNK;
  bf16* hq_s = reinterpret_cast<bf16*>(ring + S * XSTAGE);  // [R][MC 64]
  const int d0 = blockIdx.x * XDS;
  const int b = blockIdx.y;
  const int KP = (p.K + XROWS - 1) / XROWS;
  const int nit = KP * MC;
  const bf16* gb = p.g + (size_t)b * p.K * p.M;
  auto load = [&](int it) {
    if (it < nit)
      load_box<V4, XNT>(ring + (it % S) * XSTAGE, gb, p.M,
                        (it / MC) * XROWS, p.K, (it % MC) * 64, p.M, XROWS);
    cp_async_commit();
  };
  for (int r = 0; r < p.R; ++r)
    load_row<V4, XNT>(hq_s + r * MC * 64, p.hq + ((size_t)b * p.R + r) * p.M,
                      p.M, MC * 64);
  cp_async_commit();
  for (int it = 0; it < S - 1; ++it) load(it);
  cp_async_wait_upto(S - 1);   // hq; the g stages may still be in flight
  __syncthreads();
  // weff[d, m] for d in [d0, d0 + 160): a task is 2 d x 8 m, summed over
  // the ranks in order from 4-byte loads along d (a warp reads 128 bytes
  // of a row of w per load; 5 ranks' 40 loads in flight at once), written
  // as two 16-byte chunks of the K-major (d rows, m along) swizzled slice.
  constexpr int RB = 5;
  for (int t = threadIdx.x; t < (XDS / 2) * MC * 8; t += XNT) {
    const int pr = t % (XDS / 2), mb = t / (XDS / 2);
    const int d = d0 + 2 * pr, mbase = mb * 8;
    float v0[8], v1[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v0[e] = v1[e] = 0.0f;
    for (int rb = 0; rb < p.R; rb += RB) {
      __nv_bfloat162 wv[RB][8];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = rb + rr, m = mbase + e;
          wv[rr][e].x = wv[rr][e].y = bf16_zero();
          if (r >= p.R || m >= p.M || d >= p.Dh) continue;
          const bf16* q = p.w + ((size_t)r * p.M + m) * p.Dh + d;
          if (V4) {
            wv[rr][e] = *reinterpret_cast<const __nv_bfloat162*>(q);
          } else {
            wv[rr][e].x = q[0];
            if (d + 1 < p.Dh) wv[rr][e].y = q[1];
          }
        }
#pragma unroll
      for (int rr = 0; rr < RB; ++rr) {
        if (rb + rr >= p.R) break;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float h = f32(hq_s[(rb + rr) * MC * 64 + mbase + e]);
          v0[e] = v0[e] + __fmul_rn(f32(wv[rr][e].x), h);
          v1[e] = v1[e] + __fmul_rn(f32(wv[rr][e].y), h);
        }
      }
    }
    Pack8 o0, o1;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      set_lane8(o0, e, rn(v0[e]));
      set_lane8(o1, e, rn(v1[e]));
    }
    unsigned char* chunk = weff + (mb / 8) * XCHUNK;
    *reinterpret_cast<uint4*>(chunk + swizzled<128>(2 * pr, (mb % 8) * 8)) =
        o0.u;
    *reinterpret_cast<uint4*>(chunk +
                              swizzled<128>(2 * pr + 1, (mb % 8) * 8)) = o1.u;
  }
  fence_proxy_async();   // weff's generic stores, before wgmma reads them

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int qrow = (warp % 4) * 16 + lane / 4;
  const int qcol = 2 * (lane % 4);
  float acc[XDS / 2];
  for (int it = 0; it < nit; ++it) {
    cp_async_wait_upto(S - 2);   // this thread's copies of stage it
    fence_proxy_async();
    __syncthreads();       // everyone's; stage it - 1 is no longer read
    load(it + S - 1);
    const int mc = it % MC;
    const unsigned char* st = ring + (it % S) * XSTAGE + wg * 8192;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16_ss<XDS>(acc, gmma_desc<128>(st) + 2 * kk,
                         gmma_desc<128>(weff + mc * XCHUNK) + 2 * kk,
                         mc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (mc == MC - 1) {
      // dx_v rows of this pass, bf16 pairs straight from the fragment
      const int kbase = (it / MC) * XROWS + wg * 64 + qrow;
#pragma unroll
      for (int i = 0; i < XDS / 8; ++i) {
        const int d = d0 + 8 * i + qcol;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = kbase + 8 * h;
          if (k < p.K && d < p.Dh) {
            bf16* q = p.dxv + ((size_t)b * p.K + k) * p.Dh + d;
            const bf16 x0 = rn(acc[4 * i + 2 * h]);
            const bf16 x1 = rn(acc[4 * i + 2 * h + 1]);
            if (V4 && d + 1 < p.Dh) {
              __nv_bfloat162 pr;
              pr.x = x0;
              pr.y = x1;
              *reinterpret_cast<__nv_bfloat162*>(q) = pr;
            } else {
              q[0] = x0;
              if (d + 1 < p.Dh) q[1] = x1;
            }
          }
        }
      }
    }
  }
}

// -------------------------------------------------- backward: dweff, dw

template <bool V4>
__global__ void __launch_bounds__(WNT, 2)
attmutan_bwd_dweff_kernel(const BwdParams p) {
  extern __shared__ unsigned char wdyn[];
  unsigned char* ring = wdyn + ((1024 - (smem_u32(wdyn) & 1023)) & 1023);
  constexpr int S = WSTAGES;
  unsigned char* ones = ring + S * WSTAGE;
  bf16* ws = reinterpret_cast<bf16*>(ones + WONES);    // [WRG][64 m][WLD]
  float* part = reinterpret_cast<float*>(ring);         // [WRG][64][WLD]

  const unsigned rank = blockIdx.x % WCL;
  const int MT = (p.M + 63) / 64;
  const int tile = blockIdx.x / WCL;
  const int m0 = (tile % MT) * 64, dt = tile / MT, d0 = dt * 64;
  const int b_lo = p.group[rank], b_hi = p.group[rank + 1];
  const int KC = (p.K + 63) / 64;
  const int nit = (b_hi - b_lo) * KC;
  const bool with_gsum = dt == 0 && p.r0 == 0;
  auto load = [&](int it) {
    if (it < nit) {
      const int b = b_lo + it / KC, k0 = (it % KC) * 64;
      unsigned char* st = ring + (it % S) * WSTAGE;
      load_box<V4, WNT>(st, p.g + (size_t)b * p.K * p.M, p.M, k0, p.K, m0,
                        p.M, 64);
      load_box<V4, WNT>(st + 8192, p.xv + (size_t)b * p.K * p.Dh, p.Dh, k0,
                        p.K, d0, p.Dh, 64);
      if (it % KC == KC - 1)   // the epilogue's hq[b, r0 + r, m0 ..]
        for (int r = 0; r < p.nr; ++r)
          load_row<V4, WNT>(
              reinterpret_cast<bf16*>(st + 16384) + r * 64,
              p.hq + ((size_t)b * p.R + p.r0 + r) * p.M + m0,
              max(0, min(64, p.M - m0)), 64);
    }
    cp_async_commit();
  };
  // w[r0 + r, m0 + m, d0 .. d0 + 63] for the dhq parts, zeros past M, Dh
  // and nr; and the ones
  for (int i = threadIdx.x; i < WRG * 64 * 32; i += WNT) {
    const int rm = i / 32, c = (i % 32) * 2;
    const int r = rm / 64, m = m0 + rm % 64, d = d0 + c;
    const bool ok = r < p.nr && m < p.M && d < p.Dh;
    const bf16* q = p.w + ((size_t)(p.r0 + r) * p.M + m) * p.Dh + d;
    if constexpr (V4) {
      cp_async4(ws + rm * WLD + c, ok ? q : p.w, ok ? 4 : 0);
    } else {
      ws[rm * WLD + c] = ok ? q[0] : bf16_zero();
      ws[rm * WLD + c + 1] = ok && d + 1 < p.Dh ? q[1] : bf16_zero();
    }
  }
  cp_async_commit();
  for (int it = 0; it < S - 1; ++it) load(it);
  for (int i = threadIdx.x; i < WONES / 2; i += WNT)
    reinterpret_cast<bf16*>(ones)[i] = __float2bfloat16_rn(1.0f);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qrow = warp * 16 + lane / 4;   // m rows qrow, qrow + 8
  const int qcol = 2 * (lane % 4);         // d cols 8 i + qcol (+ 1)
  float dw[WRG][32];
#pragma unroll
  for (int r = 0; r < WRG; ++r)
#pragma unroll
    for (int e = 0; e < 32; ++e) dw[r][e] = 0.0f;
  float acc[32], gs[4];
  cp_async_wait<WSTAGES - 1>();   // the w tile (the first stages may fly)
  __syncthreads();
  for (int it = 0; it < nit; ++it) {
    cp_async_wait<WSTAGES - 2>();
    fence_proxy_async();   // also orders the ones' generic stores
    __syncthreads();
    load(it + S - 1);
    const unsigned char* st = ring + (it % S) * WSTAGE;
    fence_acc(acc);
    fence_acc(gs);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // dweff^T (64 m x 64 d) += g^T (m x k) x_v (k x d): both MN-major;
      // an example's first product overwrites
      const int accumulate = it % KC > 0 || kk > 0;
      wgmma_bf16_ss<64, 1, 1>(acc, gmma_desc_mn(st) + 128 * kk,
                              gmma_desc_mn(st + 8192) + 128 * kk, accumulate);
      if (with_gsum)   // gsum (64 m x 8) += g^T (m x k) ones (k x 8)
        wgmma_bf16_ss<8, 1, 0>(gs, gmma_desc_mn(st) + 128 * kk,
                               gmma_desc<128>(ones) + 2 * kk, accumulate);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    fence_acc(gs);
    if (it % KC != KC - 1) continue;
    // the example's epilogue: dw, this tile's part of dhq, gsum
    const int b = b_lo + it / KC;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ml = qrow + 8 * h, m = m0 + ml;
      const bool mok = m < p.M;
#pragma unroll
      for (int r = 0; r < WRG; ++r) {
        if (r >= p.nr) break;
        const float hv =
            f32(reinterpret_cast<const bf16*>(st + 16384)[r * 64 + ml]);
        const bf16* wrow = ws + (r * 64 + ml) * WLD + qcol;
        float part_d = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const __nv_bfloat162 wp =
              *reinterpret_cast<const __nv_bfloat162*>(wrow + 8 * i);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float a = acc[4 * i + 2 * h + c];
            dw[r][4 * i + 2 * h + c] += __fmul_rn(a, hv);
            part_d = part_d + __fmul_rn(f32(c ? wp.y : wp.x), a);
          }
        }
        part_d += __shfl_xor_sync(0xffffffffu, part_d, 1);
        part_d += __shfl_xor_sync(0xffffffffu, part_d, 2);
        if (lane % 4 == 0 && mok)
          p.pdhq[(((size_t)dt * p.B + b) * p.R + p.r0 + r) * p.M + m] =
              part_d;
      }
      if (with_gsum && lane % 4 == 0 && mok)
        p.gsum[(size_t)b * p.M + m] = gs[2 * h];
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring and the w tile are free: stage dw here
#pragma unroll
  for (int r = 0; r < WRG; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (r * 64 + qrow + 8 * h) * WLD +
                                   8 * i + qcol) =
            make_float2(dw[r][4 * i + 2 * h], dw[r][4 * i + 2 * h + 1]);
  cluster_sync();   // every group's partial is staged
  // this CTA's 8 of the 64 rows: the 8 groups' partials in group order
  // (the 8 remote loads go out before the sum waits on any)
  constexpr int ROWS = (64 + WCL - 1) / WCL;
  for (int i = threadIdx.x; i < p.nr * ROWS * 64; i += WNT) {
    const int r = i / (ROWS * 64), ml = rank * ROWS + (i / 64) % ROWS;
    const int d = i % 64;
    if (ml >= 64) continue;   // the last CTA's rows end at 64
    const float* q = part + (r * 64 + ml) * WLD + d;
    float v[WCL];
#pragma unroll
    for (int c = 0; c < WCL; ++c) v[c] = ld_cluster_f32(q, c);
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < WCL; ++c) s += v[c];
    if (m0 + ml < p.M && d0 + d < p.Dh)
      p.dw[((size_t)(p.r0 + r) * p.M + m0 + ml) * p.Dh + d0 + d] = s;
  }
  cluster_sync();   // no CTA leaves while another may still read it
}

// ------------------------------------------------- backward: dhq, db

// Blocks [0, ceil(B M / 256)): a thread per (b, m), dhq.  The rest: a warp
// per (r, m), db, lane l over the examples l, l + 32, ... then a fixed
// shuffle tree.
__global__ void attmutan_bwd_finish_kernel(const BwdParams p) {
  const int DT = (p.Dh + 63) / 64;
  const int dhq_blocks = (p.B * p.M + 255) / 256;
  if ((int)blockIdx.x < dhq_blocks) {
    const int i = blockIdx.x * 256 + threadIdx.x;
    if (i >= p.B * p.M) return;
    const int b = i / p.M, m = i % p.M;
    const float gs = p.gsum[i];
    for (int r = 0; r < p.R; ++r) {
      float s = 0.0f;
      for (int dt = 0; dt < DT; ++dt)
        s += p.pdhq[(((size_t)dt * p.B + b) * p.R + r) * p.M + m];
      p.dhq[((size_t)b * p.R + r) * p.M + m] =
          rn(s + __fmul_rn(f32(p.b3[(size_t)r * p.M + m]), gs));
    }
    return;
  }
  const int j = (blockIdx.x - dhq_blocks) * 8 + threadIdx.x / 32;
  if (j >= p.R * p.M) return;   // whole warps
  const int r = j / p.M, m = j % p.M, lane = threadIdx.x % 32;
  float s = 0.0f;
  for (int b = lane; b < p.B; b += 32)
    s += __fmul_rn(p.gsum[(size_t)b * p.M + m],
                   f32(p.hq[((size_t)b * p.R + r) * p.M + m]));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.db[j] = s;
}

size_t fwd_smem(int Dh, int R) {
  return (size_t)T * (round_up(Dh, T) + 8) * sizeof(bf16) +
         (size_t)T * LDS * sizeof(bf16) + (size_t)T * LDC * sizeof(float) +
         (size_t)(R + 1) * T * sizeof(float);
}

int set_smem(const void* fn, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <bool V4>
int bwd_launch(BwdParams p, int dx_stages, cudaStream_t st) {
  const int MC = (p.M + 63) / 64;
  p.stages = dx_stages;
  size_t smem = dx_bytes(MC, p.R, dx_stages);
  auto dx = attmutan_bwd_dx_kernel<V4>;
  int rc = set_smem(reinterpret_cast<const void*>(dx), smem);
  if (rc != 0) return rc;
  dx<<<dim3((p.Dh + XDS - 1) / XDS, p.B), XNT, smem, st>>>(p);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  smem = dweff_bytes();
  auto dweff = attmutan_bwd_dweff_kernel<V4>;
  rc = set_smem(reinterpret_cast<const void*>(dweff), smem);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(WCL * ((p.Dh + 63) / 64) * MC);
  cfg.blockDim = dim3(WNT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = WCL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (p.r0 = 0; p.r0 < p.R; p.r0 += WRG) {
    p.nr = min(WRG, p.R - p.r0);
    rc = static_cast<int>(cudaLaunchKernelEx(&cfg, dweff, p));
    if (rc != 0) return rc;
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }

  const int blocks = (p.B * p.M + 255) / 256 + (p.R * p.M + 7) / 8;
  attmutan_bwd_finish_kernel<<<blocks, 256, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// Shared memory the launches need (bytes): which 0 the forward, 1 the dx
// kernel with a ring of ``stages``, 2 the dweff kernel (its ring is 3
// deep); for the wrapper's plan and checks.
extern "C" size_t vqacx_attmutan_smem(int which, int Dh, int R, int M,
                                      int stages) {
  return which == 0 ? vqacx::fwd_smem(Dh, R)
         : which == 1
             ? (size_t)vqacx::dx_bytes((M + 63) / 64, R, stages)
             : (size_t)vqacx::dweff_bytes();
}

extern "C" int vqacx_attmutan_fwd(const void* xv, const void* w,
                                  const void* b3, const void* hq, void* out,
                                  int B, int K, int Dh, int R, int M,
                                  void* stream) {
  using namespace vqacx;
  const size_t smem = fwd_smem(Dh, R);
  int rc = set_smem(reinterpret_cast<const void*>(attmutan_fwd_kernel), smem);
  if (rc != 0) return rc;
  const bool vec = (Dh % 8 == 0) && aligned16(xv);
  const dim3 grid((M + T - 1) / T, B);
  attmutan_fwd_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xv), static_cast<const bf16*>(w),
      static_cast<const bf16*>(b3), static_cast<const bf16*>(hq),
      static_cast<bf16*>(out), K, Dh, R, M, vec);
  return static_cast<int>(cudaGetLastError());
}

// The backward (see the note at the top), with the wrapper's plan
// (attmutan_kernel.bwd_plan): CTA c of a dweff cluster takes the examples
// [groups[c], groups[c + 1]) (8 CTAs, 9 bounds from 0 to B, in order) and
// the dx ring is dx_stages deep.  Scratch (f32), the wrapper's: pdhq
// (ceil(Dh / 64), B, R, M), gsum (B, M).
extern "C" int vqacx_attmutan_bwd(const void* xv, const void* w,
                                  const void* b3, const void* hq,
                                  const void* g, void* dxv, void* dhq,
                                  void* dw, void* db, void* pdhq,
                                  void* gsum, int B, int K, int Dh, int R,
                                  int M, const int* groups, int dx_stages,
                                  void* stream) {
  using namespace vqacx;
  if (B <= 0 || K <= 0 || Dh <= 0 || R <= 0 || M <= 0 || dx_stages < 2 ||
      dx_stages > 4 || groups[0] != 0 || groups[WCL] != B)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p{};
  for (int c = 0; c <= WCL; ++c) {
    if (c > 0 && groups[c] < groups[c - 1])
      return static_cast<int>(cudaErrorInvalidValue);
    p.group[c] = groups[c];
  }
  p.xv = static_cast<const bf16*>(xv);
  p.w = static_cast<const bf16*>(w);
  p.b3 = static_cast<const bf16*>(b3);
  p.hq = static_cast<const bf16*>(hq);
  p.g = static_cast<const bf16*>(g);
  p.dxv = static_cast<bf16*>(dxv);
  p.dhq = static_cast<bf16*>(dhq);
  p.dw = static_cast<float*>(dw);
  p.db = static_cast<float*>(db);
  p.pdhq = static_cast<float*>(pdhq);
  p.gsum = static_cast<float*>(gsum);
  p.B = B;
  p.K = K;
  p.Dh = Dh;
  p.R = R;
  p.M = M;
  const bool aligned = ((reinterpret_cast<uintptr_t>(xv) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(hq) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(dxv)) & 3u) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return Dh % 2 == 0 && M % 2 == 0 && aligned
             ? bwd_launch<true>(p, dx_stages, st)
             : bwd_launch<false>(p, dx_stages, st);
}
