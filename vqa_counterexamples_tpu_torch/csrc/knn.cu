// Exact k nearest corpus rows per query, fused distance + running top-k
// (see ops/cuda/knn_kernel.py):
//   score[q, c] = 2 q.c - |q|^2 - |c|^2     (f32, = -|q - c|^2)
// the k largest per query, ties to the smallest corpus index, and
// dist = sqrt(max(-score, 0)) in ascending order.  The (Bq, N) score matrix
// never reaches device memory.
//
// Pass 1: a block owns 128 queries and one contiguous slice of the corpus,
// which it walks in tiles of 128 rows.
//  * The dot products run on the tensor cores at f32 accuracy by split
//    TF32: each operand x = hi + lo, hi = tf32(x), lo = tf32(x - hi) (both
//    rounded to nearest, ties away), and q.c = lo.hi + hi.lo + hi.hi with
//    mma.sync m16n8k8 (plain TF32 alone would change which neighbours win).
//    Each 32-deep chunk is summed into a zeroed partial that is then added
//    to the f32 accumulator: the tensor cores truncate their sums, and a
//    short partial keeps that error near f32's own rounding noise.  Every
//    column's sum runs in the same order in every tile, so equal corpus
//    rows tie exactly.
//  * D streams through a 3-stage cp.async ring of 32-deep chunks, so loads
//    overlap the math; 8 warps, each 64 queries x 32 corpus rows.
//  * Top-k is a threshold filter: each query's k-th best (score, index) so
//    far sits in shared memory; every thread compares its own accumulators
//    against their rows' thresholds in registers and appends only the
//    survivors to a 32-slot per-query candidate buffer.  A warp then merges
//    a query's candidates into its running list in (score descending,
//    index ascending) order, with shuffles and ballots.  A full buffer
//    takes another round.  After the first tiles almost nothing survives.
//    The lists sit in shared memory when 128 of them fit beside the ring
//    (k <= 84 on the H100), else in the per-slice scratch in device
//    memory: k has no cap but N.
// Pass 2: one thread per query merges the slices' lists, slice by slice in
// index order (ties again to the smaller index).
// Pass 3: one block per query scores its k winners again as f32 dot
// products summed in index order and writes them sorted, with distances.
#include <float.h>
#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace vqacx {
namespace {

constexpr int QB = 128;        // queries per block
constexpr int CB = 128;        // corpus rows per tile
constexpr int BK = 32;         // depth per pipeline stage
constexpr int STAGES = 3;
constexpr int LDK = BK + 4;    // stage row stride in floats: the fragment
                               // reads of a warp hit 32 distinct banks
constexpr int NT = 256;        // 8 warps: 2 along the queries x 4 along
                               // the corpus rows, 64 x 32 each
constexpr int CAP = 32;        // candidate slots per query and round
constexpr int MAX_SLICES = 256;
constexpr int STAGE_FLOATS = (QB + CB) * LDK;
constexpr size_t SMEM = (size_t)STAGES * STAGE_FLOATS * 4  // operand ring
                        + (size_t)QB * CAP * 8             // candidates
                        + (size_t)QB * 16 + 16;            // per-query state

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// tf32 by round to nearest, ties away from zero (cvt.rna.tf32.f32 on
// finite values), as the bits the tensor cores read
__device__ __forceinline__ unsigned tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(__fsub_rn(x, __uint_as_float(hi)));
}

// One stage: rows [q0, q0 + QB) of q and [c0, c0 + CB) of c, columns
// [d0, d0 + BK); zeros past Bq, c_hi and D.
template <bool VEC>
__device__ __forceinline__ void load_stage(float* st, const float* q,
                                           const float* c, int q0, int Bq,
                                           int c0, int c_hi, int d0, int D) {
  float* As = st;
  float* Bs = st + QB * LDK;
  if constexpr (VEC) {   // D % 4 == 0: a 16-byte chunk is wholly in or out
#pragma unroll
    for (int e = 0; e < QB * BK / 4 / NT; ++e) {
      const int i = threadIdx.x + e * NT;
      const int r = i / (BK / 4), cc = (i % (BK / 4)) * 4;
      const bool dv = d0 + cc < D;
      const bool qa = q0 + r < Bq && dv, ca = c0 + r < c_hi && dv;
      cp_async16(As + r * LDK + cc,
                 qa ? q + (size_t)(q0 + r) * D + d0 + cc : q, qa ? 16 : 0);
      cp_async16(Bs + r * LDK + cc,
                 ca ? c + (size_t)(c0 + r) * D + d0 + cc : c, ca ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int e = 0; e < QB * BK / NT; ++e) {
      const int i = threadIdx.x + e * NT;
      const int r = i / BK, cc = i % BK;
      const bool dv = d0 + cc < D;
      const bool qa = q0 + r < Bq && dv, ca = c0 + r < c_hi && dv;
      cp_async4(As + r * LDK + cc,
                qa ? q + (size_t)(q0 + r) * D + d0 + cc : q, qa ? 4 : 0);
      cp_async4(Bs + r * LDK + cc,
                ca ? c + (size_t)(c0 + r) * D + d0 + cc : c, ca ? 4 : 0);
    }
  }
}

// A warp merges query row r's candidates (n of them, one per lane) into
// its running list lv/li (len entries, best first; at most k kept), and
// moves the row's threshold to the list's k-th entry once it has k.  The
// list lies in shared or device memory (generic pointers).
__device__ void merge_row(int r, int n, const float* cand_v,
                          const int* cand_i, float* lv, int* li, int* len,
                          float* thr_v, int* thr_i, int k) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int L = len[r];
  float cv = -INFINITY;
  int ci = INT_MAX;
  if (lane < n) {
    cv = cand_v[r * CAP + lane];
    ci = cand_i[r * CAP + lane];
  }
  // the candidate's place: its rank among the candidates plus the list
  // entries before it; an entry's: its index plus the candidates before it
  int pos = 0;
  for (int m = 0; m < n; ++m)
    pos += better(__shfl_sync(FULL, cv, m), __shfl_sync(FULL, ci, m), cv,
                  ci);
  // entries only move down: last chunk first, each read before written
  for (int j0 = L > 0 ? ((L - 1) / 32) * 32 : -1; j0 >= 0; j0 -= 32) {
    const int j = j0 + lane;
    const bool has = j < L;
    float ev = 0.0f;
    int ei = 0, np = j;
    if (has) {
      ev = lv[j];
      ei = li[j];
    }
    for (int m = 0; m < n; ++m) {
      // every lane shuffles: none may skip a full-mask shuffle
      const float mv = __shfl_sync(FULL, cv, m);
      const int mi = __shfl_sync(FULL, ci, m);
      const bool first = has && better(ev, ei, mv, mi);
      np += has && !first;
      const int ahead = __popc(__ballot_sync(FULL, first));
      if (lane == m) pos += ahead;
    }
    __syncwarp();
    if (has && np < k) {
      lv[np] = ev;
      li[np] = ei;
      if (np == k - 1) {
        thr_v[r] = ev;
        thr_i[r] = ei;
      }
    }
    __syncwarp();
  }
  if (lane < n && pos < k) {
    lv[pos] = cv;
    li[pos] = ci;
    if (pos == k - 1) {
      thr_v[r] = cv;
      thr_i[r] = ci;
    }
  }
  __syncwarp();
  if (lane == 0) len[r] = min(k, L + n);
}

template <bool VEC>
__global__ void __launch_bounds__(NT, 1)
knn_partial_kernel(const float* __restrict__ q,     // (Bq, D)
                   const float* __restrict__ qsq,   // (Bq,)
                   const float* __restrict__ c,     // (N, D)
                   const float* __restrict__ csq,   // (N,)
                   float* __restrict__ pvals,       // (S, Bq, k)
                   int* __restrict__ pidx,          // (S, Bq, k)
                   int Bq, int N, int D, int k, int slice,
                   bool smem_lists) {
  extern __shared__ __align__(16) float smem[];
  float* cand_v = smem + STAGES * STAGE_FLOATS;          // (QB, CAP)
  int* cand_i = reinterpret_cast<int*>(cand_v + QB * CAP);
  float* thr_v = reinterpret_cast<float*>(cand_i + QB * CAP);  // (QB,)
  int* thr_i = reinterpret_cast<int*>(thr_v + QB);
  int* cnt = thr_i + QB;
  int* len = cnt + QB;
  int* flag = len + QB;                                  // (2,)
  // the running lists: (QB, k) after the per-query state when they fit,
  // else the slice's rows of the scratch
  float* lists_v = reinterpret_cast<float*>(flag + 4);
  int* lists_i = reinterpret_cast<int*>(lists_v + QB * k);

  const int q0 = blockIdx.x * QB;
  const int s = blockIdx.y;
  const int c_lo = s * slice;
  const int c_hi = min(N, c_lo + slice);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 2, wn = warp / 2;
  const int g = lane / 4, t = lane % 4;

  for (int r = threadIdx.x; r < QB; r += NT) {
    thr_v[r] = -INFINITY;
    thr_i[r] = INT_MAX;
    cnt[r] = 0;
    len[r] = 0;
  }
  if (threadIdx.x < 2) flag[threadIdx.x] = 0;

  // this thread's 8 query rows: m-tile i, half h -> slot i * 2 + h
  float qn[8];
  bool row_ok[8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + wm * 64 + i * 16 + g + h * 8;
      row_ok[i * 2 + h] = r < Bq;
      qn[i * 2 + h] = r < Bq ? qsq[r] : 0.0f;
    }

  const int tiles = (c_hi - c_lo + CB - 1) / CB;
  const int nk = (D + BK - 1) / BK;
  const int total = tiles * nk;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < total)
      load_stage<VEC>(smem + p * STAGE_FLOATS, q, c, q0, Bq,
                      c_lo + (p / nk) * CB, c_hi, (p % nk) * BK, D);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  for (int it = 0; it < total; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nx = it + STAGES - 1;
      if (nx < total)
        load_stage<VEC>(smem + (nx % STAGES) * STAGE_FLOATS, q, c, q0, Bq,
                        c_lo + (nx / nk) * CB, c_hi, (nx % nk) * BK, D);
      cp_async_commit();
    }
    const float* As = smem + (it % STAGES) * STAGE_FLOATS + (wm * 64) * LDK;
    const float* Bs = smem + (it % STAGES) * STAGE_FLOATS + QB * LDK
                      + (wn * 32) * LDK;
    float part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* b = Bs + (j * 8 + g) * LDK + kk + t;
        split_tf32(b[0], bh[j][0], bl[j][0]);
        split_tf32(b[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* a = As + (i * 16 + g) * LDK + kk + t;
        unsigned ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);
        split_tf32(a[8 * LDK], ah[1], al[1]);
        split_tf32(a[4], ah[2], al[2]);
        split_tf32(a[8 * LDK + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32_1688(part[i][j], al, bh[j][0], bh[j][1]);
          mma_tf32_1688(part[i][j], ah, bl[j][0], bl[j][1]);
          mma_tf32_1688(part[i][j], ah, bh[j][0], bh[j][1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
    if (it % nk != nk - 1) continue;

    // ---- the tile's scores through the threshold filter
    const int c0 = c_lo + (it / nk) * CB;
    float cn[4][2];
    bool col_ok[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c0 + wn * 32 + j * 8 + 2 * t + e;
        col_ok[j][e] = cc < c_hi;
        cn[j][e] = cc < c_hi ? csq[cc] : 0.0f;
      }
    // bit (i * 4 + j) * 4 + e: the score is placed or can never enter
    unsigned long long done = 0ull;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float v = __fsub_rn(__fsub_rn(2.0f * acc[i][j][e],
                                              qn[i * 2 + e / 2]),
                                    cn[j][e % 2]);
          acc[i][j][e] = v;
          if (!row_ok[i * 2 + e / 2] || !col_ok[j][e % 2])
            done |= 1ull << ((i * 4 + j) * 4 + e);
        }
    for (int round = 0;; ++round) {
      float tv[8];
      int ti[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * 64 + i * 16 + g + h * 8;
          tv[i * 2 + h] = thr_v[r];
          ti[i * 2 + h] = thr_i[r];
        }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const unsigned long long bit = 1ull << ((i * 4 + j) * 4 + e);
            if (done & bit) continue;
            const int slot_r = i * 2 + e / 2;
            const int cidx = c0 + wn * 32 + j * 8 + 2 * t + e % 2;
            const float v = acc[i][j][e];
            if (better(v, cidx, tv[slot_r], ti[slot_r])) {
              const int r = wm * 64 + i * 16 + g + (e / 2) * 8;
              const int slot = atomicAdd(&cnt[r], 1);
              if (slot < CAP) {
                cand_v[r * CAP + slot] = v;
                cand_i[r * CAP + slot] = cidx;
                done |= bit;
              } else {
                flag[round & 1] = 1;   // no room: try again next round
              }
            } else {
              done |= bit;   // the threshold only rises
            }
          }
      __syncthreads();
      const bool again = flag[round & 1] != 0;
      if (threadIdx.x == 0) flag[(round + 1) & 1] = 0;
      for (int r = warp; r < QB; r += NT / 32) {
        const int n = min(cnt[r], CAP);
        if (n == 0) continue;
        const size_t base = smem_lists ? (size_t)r * k
                                       : ((size_t)s * Bq + q0 + r) * k;
        merge_row(r, n, cand_v, cand_i,
                  (smem_lists ? lists_v : pvals) + base,
                  (smem_lists ? lists_i : pidx) + base, len, thr_v, thr_i,
                  k);
        if (lane == 0) cnt[r] = 0;
      }
      __syncthreads();
      if (!again) break;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }
  cp_async_wait<0>();

  // to the scratch; a slice shorter than k leaves its list's tail empty
  for (int r = warp; r < QB; r += NT / 32) {
    if (q0 + r >= Bq) continue;
    const size_t base = ((size_t)s * Bq + q0 + r) * k;
    for (int j = lane; j < k; j += 32) {
      const bool has = j < len[r];
      if (smem_lists) {
        pvals[base + j] = has ? lists_v[r * k + j] : -INFINITY;
        pidx[base + j] = has ? lists_i[r * k + j] : INT_MAX;
      } else if (!has) {
        pvals[base + j] = -INFINITY;
        pidx[base + j] = INT_MAX;
      }
    }
  }
}

// The slices' lists in index order: the k winners' indices per query.
__global__ void knn_merge_kernel(const float* __restrict__ pvals,
                                 const int* __restrict__ pidx,
                                 int* __restrict__ idx,      // (Bq, k)
                                 int Bq, int k, int S) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Bq) return;
  int pos[MAX_SLICES];
  for (int s = 0; s < S; ++s) pos[s] = 0;
  for (int j = 0; j < k; ++j) {
    int bs = -1;
    float bv = 0.0f;
    int bi = 0;
    for (int s = 0; s < S; ++s) {
      if (pos[s] >= k) continue;
      const size_t o = ((size_t)s * Bq + qi) * k + pos[s];
      const float v = pvals[o];
      const int i = pidx[o];
      if (bs < 0 || better(v, i, bv, bi)) {
        bs = s;
        bv = v;
        bi = i;
      }
    }
    ++pos[bs];
    idx[(size_t)qi * k + j] = bi;
  }
}

// One block per query: each winner's score again as one f32 dot product
// summed in index order (the order of the plain f32 GEMM), then the k in
// (score descending, index ascending) order and their distances.  Near
// zero the split's rounding and f32's differ by more than f32's own
// noise; this keeps every reported distance f32's.
__global__ void knn_rescore_kernel(const float* __restrict__ q,
                                   const float* __restrict__ qsq,
                                   const float* __restrict__ c,
                                   const float* __restrict__ csq,
                                   float* __restrict__ sv,     // (Bq, k)
                                   int* __restrict__ si,       // (Bq, k)
                                   float* __restrict__ dist,   // (Bq, k)
                                   int* __restrict__ idx,      // (Bq, k)
                                   int D, int k) {
  const size_t row = (size_t)blockIdx.x * k;
  const float* qr = q + (size_t)blockIdx.x * D;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const int ci = idx[row + j];
    const float* cr = c + (size_t)ci * D;
    float acc = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) acc = fmaf(qr[d], cr[d], acc);
    sv[row + j] = __fsub_rn(__fsub_rn(2.0f * acc, qsq[blockIdx.x]), csq[ci]);
    si[row + j] = ci;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float v = sv[row + j];
    const int i = si[row + j];
    int rank = 0;
    for (int m = 0; m < k; ++m) rank += better(sv[row + m], si[row + m], v, i);
    dist[row + rank] = sqrtf(fmaxf(-v, 0.0f));
    idx[row + rank] = i;
  }
}

template <bool VEC>
int launch_partial(const float* q, const float* qsq, const float* c,
                   const float* csq, float* pvals, int* pidx, int Bq, int N,
                   int D, int k, int slice, int S, cudaStream_t st) {
  int dev = 0, optin = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (rc != 0) return rc;
  const size_t with_lists = SMEM + (size_t)QB * k * 8;
  const bool smem_lists = with_lists <= (size_t)optin;
  const size_t smem = smem_lists ? with_lists : SMEM;
  rc = static_cast<int>(cudaFuncSetAttribute(
      knn_partial_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  knn_partial_kernel<VEC><<<dim3((Bq + QB - 1) / QB, S), NT, smem, st>>>(
      q, qsq, c, csq, pvals, pidx, Bq, N, D, k, slice, smem_lists);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// Scratch: pvals (S, Bq, k) f32 and pidx (S, Bq, k) int32, S =
// ceil(N / slice) <= 256; slice a multiple of 128; any k <= N.
extern "C" int vqacx_knn(const void* q, const void* qsq, const void* c,
                         const void* csq, void* dist, void* idx, void* pvals,
                         void* pidx, int Bq, int N, int D, int k, int slice,
                         void* stream) {
  using namespace vqacx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = (N + slice - 1) / slice;
  if (S > MAX_SLICES || slice % CB != 0 || k < 1 || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = D % 4 == 0 && aligned16(q) && aligned16(c);
  const float* q_ = static_cast<const float*>(q);
  const float* c_ = static_cast<const float*>(c);
  const float* qsq_ = static_cast<const float*>(qsq);
  const float* csq_ = static_cast<const float*>(csq);
  float* pv = static_cast<float*>(pvals);
  int* pi = static_cast<int*>(pidx);
  int* idx_ = static_cast<int*>(idx);
  int rc = vec ? launch_partial<true>(q_, qsq_, c_, csq_, pv, pi, Bq, N, D,
                                      k, slice, S, st)
               : launch_partial<false>(q_, qsq_, c_, csq_, pv, pi, Bq, N, D,
                                       k, slice, S, st);
  if (rc != 0) return rc;
  knn_merge_kernel<<<(Bq + 127) / 128, 128, 0, st>>>(pv, pi, idx_, Bq, k, S);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  // the first slice's scratch is free again: it holds the rescored list
  knn_rescore_kernel<<<Bq, 64, 0, st>>>(q_, qsq_, c_, csq_, pv, pi,
                                        static_cast<float*>(dist), idx_, D,
                                        k);
  return static_cast<int>(cudaGetLastError());
}
