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
// Forward, one launch (the wrapper's plan, attmutan_kernel.fwd_plan): a
// CTA owns (example, NB of M) over all K positions.  It builds its weff
// slice once, in shared memory (K-major: NB rows of m, Dh along,
// 128B-swizzled), from one pass over its rows of w: they are contiguous in
// each rank, so a warp's load takes 256 bytes of one rank (8-byte loads),
// 5 ranks x 4 loads a thread in flight and the next round's out before
// this round's sums; the sums run in f32 in JAX's rank order and round
// once; the first x_v stages load
// meanwhile.  Then NWG warpgroups stream x_v (64 NWG positions x 64 of Dh
// a stage) through a cp.async ring into wgmma (m64 x NB), stage bf16(acc +
// bias) in the stage they just read and write whole rows of out.  Rows of
// 620 bytes are off TMA's 16-byte strides, so 4-byte copies fill the
// stages (16-byte ones where Dh % 8 == 0).  Each example's weff is built
// once in all: w (1.6 MB at MutanAtt's shape) is read from L2 once per
// example.
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
#include <type_traits>

#include "common.cuh"

namespace vqacx {
namespace {

// ---------------------------------------------------------------- forward

constexpr int FRB = 5;    // forward build: ranks whose loads fly together
constexpr int FU = 4;     // forward build: items per thread per round

// Shared memory (bytes, with the 1024-byte alignment slack): the weff
// slice (dc chunks of nb rows x 128 bytes), a ring of 64 nwg positions x
// 128 bytes a stage, hq (R x nb) and the bias (nb) in f32.
__host__ __device__ constexpr int fwd_bytes(int nb, int nwg, int dc, int R,
                                            int stages) {
  return 1024 + dc * nb * 128 + stages * nwg * 8192 + (R + 1) * nb * 4;
}

struct FwdParams {
  const bf16* xv;    // (B, K, Dh)
  const bf16* w;     // (R * M, Dh)
  const bf16* b3;    // (R, M)
  const bf16* hq;    // (B, R, M)
  bf16* out;         // (B, K, M)
  int B, K, Dh, R, M;
  int stages;
};

// Element e of 4 bf16 loaded as one 8-byte word, as f32 (a shift).
__device__ __forceinline__ float wlane(const uint2& v, int e) {
  const unsigned x = e < 2 ? v.x : v.y;
  return __uint_as_float(e % 2 ? x & 0xffff0000u : x << 16);
}

// The 128 threads of warpgroup wg meet (named barrier 1 + wg).
__device__ __forceinline__ void wg_sync(int wg) {
  if (wg) named_sync<2, 128>(); else named_sync<1, 128>();
}

// 5f: a CTA owns (example b, NB of M) over all K positions (see the note
// at the top).  NB / WN wgmma products of width WN make the m64 x NB one.
template <int NB, int NWG, int VEC>
__global__ void __launch_bounds__(NWG * 128, 1)
attmutan_fwd_kernel(const FwdParams p) {
  constexpr int E = VEC > 1 ? 4 : 1;      // elements of w a load
  using Word = std::conditional_t<E == 4, uint2, bf16>;
  constexpr int NTH = NWG * 128;
  constexpr int ROWS = NWG * 64;          // positions per stage
  constexpr int STAGE = ROWS * 128;
  constexpr int WN = NB < 128 ? NB : 128;
  constexpr int NSUB = NB / WN;
  extern __shared__ unsigned char fdyn[];
  unsigned char* weff = fdyn + ((1024 - (smem_u32(fdyn) & 1023)) & 1023);
  const int DC = (p.Dh + 63) / 64, S = p.stages;
  unsigned char* ring = weff + DC * NB * 128;
  float* hq_s = reinterpret_cast<float*>(ring + S * STAGE);   // [R][NB]
  float* bias_s = hq_s + p.R * NB;                             // [NB]
  const int m0 = blockIdx.x * NB, b = blockIdx.y;
  const int nm = min(NB, p.M - m0);   // the slice's rows inside M
  const int KP = (p.K + ROWS - 1) / ROWS;
  const int nit = KP * DC;
  const bf16* xb = p.xv + (size_t)b * p.K * p.Dh;
  auto load = [&](int it) {
    if (it < nit)
      load_box<VEC, NTH>(ring + (it % S) * STAGE, xb, p.Dh, (it / DC) * ROWS,
                         p.K, (it % DC) * 64, p.Dh, ROWS);
    cp_async_commit();
  };
  for (int it = 0; it < S - 1; ++it) load(it);

  // weff[m, d] = bf16(sum_r w[r M + m, d] hq[b, r, m]), the sum over the
  // ranks in order, each product rounded on its own (JAX's order, no FMA).
  // Item j is E elements at flat offset E j of the slice's nm x Dh
  // elements: the same offset in each rank's nm rows of w, which are
  // contiguous, so a warp's load takes 32 E x 2 bytes of one rank.  A
  // round loads FRB ranks x FU items a thread; the next round's loads go
  // out before this round's sums.
  const int nitems = nm * p.Dh / E;
  const size_t rstride = (size_t)p.M * p.Dh;
  const bf16* wb = p.w + (size_t)m0 * p.Dh;
  auto fetch = [&](Word (&v)[FRB][FU], int j0, int rb) {
#pragma unroll
    for (int rr = 0; rr < FRB; ++rr)
#pragma unroll
      for (int u = 0; u < FU; ++u) {
        const int j = j0 + u * NTH + threadIdx.x;
        const bool ok = j < nitems && rb + rr < p.R;
        const bf16* q = wb + (rb + rr) * rstride + (size_t)E * j;
        if constexpr (E == 4)
          v[rr][u] = ok ? __ldg(reinterpret_cast<const uint2*>(q))
                        : make_uint2(0, 0);
        else
          v[rr][u] = ok ? q[0] : bf16_zero();
      }
  };
  Word cur[FRB][FU], nxt[FRB][FU];
  fetch(cur, 0, 0);   // in flight while hq, the pad and the bias are set

  for (int i = threadIdx.x; i < p.R * NB; i += NTH) {
    const int r = i / NB, mm = i % NB;
    hq_s[i] = mm < nm ? f32(p.hq[((size_t)b * p.R + r) * p.M + m0 + mm])
                      : 0.0f;
  }
  // the slice's pad is zero: rows nm .. NB of every chunk (16-byte chunks),
  // columns Dh .. 64 DC of the last chunk
  for (int i = threadIdx.x; i < (NB - nm) * DC * 8; i += NTH) {
    const int q = i % 8, row = nm + (i / 8) % (NB - nm);
    const int c = i / (8 * (NB - nm));
    *reinterpret_cast<uint4*>(weff + c * NB * 128 +
                              swizzled<128>(row, 8 * q)) = uint4{0, 0, 0, 0};
  }
  const int tail = DC * 64 - p.Dh;
  for (int i = threadIdx.x; i < nm * tail; i += NTH) {
    const int row = i / tail, d = p.Dh + i % tail - (DC - 1) * 64;
    *reinterpret_cast<bf16*>(weff + (DC - 1) * NB * 128 +
                             swizzled<128>(row, d)) = bf16_zero();
  }
  __syncthreads();   // hq_s
  for (int mm = threadIdx.x; mm < NB; mm += NTH) {
    float s = 0.0f;
    if (mm < nm)
      for (int r = 0; r < p.R; ++r)
        s = s + __fmul_rn(f32(p.b3[(size_t)r * p.M + m0 + mm]),
                          hq_s[r * NB + mm]);
    bias_s[mm] = s;
  }

  for (int j0 = 0; j0 < nitems; j0 += NTH * FU) {
    // each item's row and column, and where its second pair lands (E 4:
    // the pair may start the next row)
    int row[FU], col[FU], row2[FU], col2[FU];
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      const int f = E * (j0 + u * NTH + threadIdx.x);
      row[u] = f / p.Dh;
      col[u] = f - row[u] * p.Dh;
      const bool wrap = E == 4 && col[u] + 2 >= p.Dh;
      row2[u] = min(row[u] + (wrap ? 1 : 0), NB - 1);
      col2[u] = wrap ? col[u] + 2 - p.Dh : col[u] + 2;
      row[u] = min(row[u], NB - 1);
    }
    float acc[FU][E];
#pragma unroll
    for (int u = 0; u < FU; ++u)
#pragma unroll
      for (int e = 0; e < E; ++e) acc[u][e] = 0.0f;
    for (int rb = 0; rb < p.R; rb += FRB) {
      const bool last = rb + FRB >= p.R;
      if (!last || j0 + NTH * FU < nitems)
        fetch(nxt, last ? j0 + NTH * FU : j0, last ? 0 : rb + FRB);
#pragma unroll
      for (int rr = 0; rr < FRB; ++rr) {
        if (rb + rr >= p.R) break;
        const float* hr = hq_s + (rb + rr) * NB;
#pragma unroll
        for (int u = 0; u < FU; ++u) {
          const float h = hr[row[u]];
          const float h2 = E == 4 ? hr[row2[u]] : h;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            float wv;
            if constexpr (E == 4)
              wv = wlane(cur[rr][u], e);
            else
              wv = f32(cur[rr][u]);
            acc[u][e] = acc[u][e] + __fmul_rn(wv, e < 2 ? h : h2);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < FRB; ++rr)
#pragma unroll
        for (int u = 0; u < FU; ++u) cur[rr][u] = nxt[rr][u];
    }
#pragma unroll
    for (int u = 0; u < FU; ++u) {
      if (j0 + u * NTH + threadIdx.x >= nitems) continue;
      if constexpr (E == 1) {
        *reinterpret_cast<bf16*>(weff + (col[u] / 64) * NB * 128 +
                                 swizzled<128>(row[u], col[u] % 64)) =
            rn(acc[u][0]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // a pair never straddles a row
          const int rw = h ? row2[u] : row[u], cl = h ? col2[u] : col[u];
          __nv_bfloat162 pr;
          pr.x = rn(acc[u][2 * h]);
          pr.y = rn(acc[u][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              weff + (cl / 64) * NB * 128 + swizzled<128>(rw, cl % 64)) = pr;
        }
      }
    }
  }
  fence_proxy_async();   // weff's generic stores, before wgmma reads them

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int qrow = (warp % 4) * 16 + lane / 4;
  const int qcol = 2 * (lane % 4);
  const bool pairs = p.M % 2 == 0;
  float acc[NSUB][WN / 2];
  for (int it = 0; it < nit; ++it) {
    cp_async_wait_upto(S - 2);   // this thread's copies of stage it
    fence_proxy_async();
    __syncthreads();   // everyone's (and the bias); stage it - 1 is free
    load(it + S - 1);
    const int c = it % DC;
    const unsigned char* st = ring + (it % S) * STAGE + wg * 8192;
    const unsigned char* wc = weff + c * NB * 128;
#pragma unroll
    for (int n = 0; n < NSUB; ++n) fence_acc(acc[n]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NSUB; ++n)
        wgmma_bf16_ss<WN>(acc[n], gmma_desc<128>(st) + 2 * kk,
                          gmma_desc<128>(wc + n * WN * 128) + 2 * kk,
                          c > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NSUB; ++n) fence_acc(acc[n]);
    if (c != DC - 1) continue;
    // out rows of this pass, 64 columns at a time: the warpgroup stages
    // bf16(acc + bias) in its half of the stage it just read (the next
    // load into it comes after the loop's barrier), then each warp writes
    // whole rows, 128 contiguous bytes an instruction
    unsigned char* tile = ring + (it % S) * STAGE + wg * 8192;
    const int k0 = (it / DC) * ROWS + wg * 64;
    bf16* ob = p.out + ((size_t)b * p.K + k0) * p.M + m0;
#pragma unroll
    for (int n = 0; n < NB / 64; ++n) {
      const int sub = n * 64 / WN, i0 = (n * 64 % WN) / 8;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ml = n * 64 + 8 * i + qcol;
          __nv_bfloat162 pr;
          pr.x = rn(acc[sub][4 * (i0 + i) + 2 * h] + bias_s[ml]);
          pr.y = rn(acc[sub][4 * (i0 + i) + 2 * h + 1] + bias_s[ml + 1]);
          *reinterpret_cast<__nv_bfloat162*>(
              tile + swizzled<128>(qrow + 8 * h, 8 * i + qcol)) = pr;
        }
      wg_sync(wg);
      const int ml = n * 64 + 2 * lane;
      for (int r = warp % 4; r < 64 && k0 + r < p.K; r += 4) {
        const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(
            tile + swizzled<128>(r, 2 * lane));
        bf16* q = ob + (size_t)r * p.M + ml;
        if (pairs && ml + 1 < nm) {
          *reinterpret_cast<__nv_bfloat162*>(q) = pr;
        } else if (ml < nm) {
          q[0] = pr.x;
          if (ml + 1 < nm) q[1] = pr.y;
        }
      }
      wg_sync(wg);   // the tile is free for the next 64 columns
    }
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
      load_box<V4 ? 2 : 1, XNT>(ring + (it % S) * XSTAGE, gb, p.M,
                                (it / MC) * XROWS, p.K, (it % MC) * 64, p.M,
                                XROWS);
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
      load_box<V4 ? 2 : 1, WNT>(st, p.g + (size_t)b * p.K * p.M, p.M, k0,
                                p.K, m0, p.M, 64);
      load_box<V4 ? 2 : 1, WNT>(st + 8192, p.xv + (size_t)b * p.K * p.Dh,
                                p.Dh, k0, p.K, d0, p.Dh, 64);
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

template <int NB, int NWG>
int fwd_launch(const FwdParams& p, int vec, cudaStream_t st) {
  auto k = vec == 8   ? attmutan_fwd_kernel<NB, NWG, 8>
           : vec == 2 ? attmutan_fwd_kernel<NB, NWG, 2>
                      : attmutan_fwd_kernel<NB, NWG, 1>;
  const size_t smem = fwd_bytes(NB, NWG, (p.Dh + 63) / 64, p.R, p.stages);
  int rc = set_smem(reinterpret_cast<const void*>(k), smem);
  if (rc != 0) return rc;
  k<<<dim3((p.M + NB - 1) / NB, p.B), NWG * 128, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// Shared memory the launches need (bytes): which 0 the forward with the
// configuration nb / nwg (its ring ``stages`` deep), 1 the dx kernel with
// a ring of ``stages``, 2 the dweff kernel (its ring is 3 deep); for the
// wrapper's plans and checks.
extern "C" size_t vqacx_attmutan_smem(int which, int Dh, int R, int M,
                                      int stages, int nb, int nwg) {
  return which == 0 ? (size_t)vqacx::fwd_bytes(nb, nwg, (Dh + 63) / 64, R,
                                               stages)
         : which == 1
             ? (size_t)vqacx::dx_bytes((M + 63) / 64, R, stages)
             : (size_t)vqacx::dweff_bytes();
}

// The forward (see the note at the top) with the wrapper's plan
// (attmutan_kernel.fwd_plan): NB of M a CTA, NWG warpgroups, a ring of
// ``stages`` (2 to 4) x_v stages.  Where Dh is even, M Dh % 4 == 0 and w
// is 8-byte aligned, w arrives by 8-byte loads and x_v by 16-byte copies
// (Dh % 8 == 0 and a 16-byte aligned base) or 4-byte ones; plain loads
// otherwise.
extern "C" int vqacx_attmutan_fwd(const void* xv, const void* w,
                                  const void* b3, const void* hq, void* out,
                                  int B, int K, int Dh, int R, int M, int nb,
                                  int nwg, int stages, void* stream) {
  using namespace vqacx;
  if (B <= 0 || K <= 0 || Dh <= 0 || R <= 0 || M <= 0 || stages < 2 ||
      stages > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{static_cast<const bf16*>(xv), static_cast<const bf16*>(w),
              static_cast<const bf16*>(b3), static_cast<const bf16*>(hq),
              static_cast<bf16*>(out), B, K, Dh, R, M, stages};
  const uintptr_t ax = reinterpret_cast<uintptr_t>(xv);
  const bool quads = Dh % 2 == 0 && (long long)M * Dh % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(w) & 7u) == 0;
  const int vec = !quads || (ax & 3u) != 0      ? 1
                  : Dh % 8 == 0 && (ax & 15u) == 0 ? 8
                                                   : 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb == 256 && nwg == 2) return fwd_launch<256, 2>(p, vec, st);
  if (nb == 128 && nwg == 2) return fwd_launch<128, 2>(p, vec, st);
  if (nb == 64 && nwg == 1) return fwd_launch<64, 1>(p, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
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
