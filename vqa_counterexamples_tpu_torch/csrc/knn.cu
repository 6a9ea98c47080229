// Exact k nearest corpus rows per query, fused distance + running top-k
// (see ops/cuda/knn_kernel.py):
//   score[q, c] = 2 q.c - |q|^2 - |c|^2     (f32, = -|q - c|^2)
// the k largest per query, ties to the smallest corpus index, and
// dist = sqrt(max(-score, 0)) in ascending order.  The (Bq, N) score matrix
// never reaches device memory.
//
// Pass 1: a block owns 64 queries and one contiguous slice of the corpus.
// It walks the slice in tiles of 64 rows: the 64 x 64 dot tile in f32 FMAs
// (no TF32: it would change which neighbours win), 256 threads with 4 x 4
// outputs each, D in chunks of 16 staged in shared memory; then one thread
// per query scans the tile's scores in index order into its running list
// (descending, ties in index order), kept in dynamic shared memory sized
// from k (64 x k values and indices: k up to about 400 within the H100's
// 227 KB a block).  A score enters
// only if it beats the list's last entry, so an equal score with a larger
// index never displaces a smaller one.  Columns past the slice are never
// scanned.  The slice's list goes to device memory.
// Pass 2: one thread per query merges the slices' lists, slice by slice in
// index order (ties again to the smaller index), and writes the distances.
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace vqacx {
namespace {

constexpr int QB = 64;     // queries per block
constexpr int CB = 64;     // corpus rows per tile
constexpr int BD = 16;     // D chunk
constexpr int NT = 256;
// shared memory a block holds besides the running lists
constexpr int STATIC_SMEM = (2 * BD * QB + QB * (CB + 1)) * 4;

size_t list_smem(int k) { return (size_t)QB * k * (sizeof(float) + sizeof(int)); }

__global__ void __launch_bounds__(NT)
knn_partial_kernel(const float* __restrict__ q,     // (Bq, D)
                   const float* __restrict__ qsq,   // (Bq,)
                   const float* __restrict__ c,     // (N, D)
                   const float* __restrict__ csq,   // (N,)
                   float* __restrict__ pvals,       // (S, Bq, k)
                   int* __restrict__ pidx,          // (S, Bq, k)
                   int Bq, int N, int D, int k, int slice) {
  __shared__ float As[BD][QB];
  __shared__ float Bs[BD][CB];
  __shared__ float Ss[QB][CB + 1];
  extern __shared__ float lists[];
  float* lv = lists;                                 // (QB, k)
  int* li = reinterpret_cast<int*>(lists + QB * k);  // (QB, k)

  const int q0 = blockIdx.x * QB;
  const int s = blockIdx.y;
  const int c_lo = s * slice;
  const int c_hi = min(N, c_lo + slice);
  const int tx = threadIdx.x % 16;   // 4 corpus columns each
  const int ty = threadIdx.x / 16;   // 4 query rows each

  for (int i = threadIdx.x; i < QB * k; i += NT) {
    lv[i] = -INFINITY;
    li[i] = 0x7fffffff;
  }
  for (int c0 = c_lo; c0 < c_hi; c0 += CB) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int d0 = 0; d0 < D; d0 += BD) {
#pragma unroll
      for (int e = 0; e < QB * BD / NT; ++e) {
        const int i = threadIdx.x + e * NT;
        const int r = i / BD, dd = i % BD;
        const int d = d0 + dd;
        As[dd][r] = (q0 + r < Bq && d < D) ? q[(size_t)(q0 + r) * D + d]
                                           : 0.0f;
        Bs[dd][r] = (c0 + r < c_hi && d < D) ? c[(size_t)(c0 + r) * D + d]
                                             : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < BD; ++dd) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[dd][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[dd][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float qn = q0 + r < Bq ? qsq[q0 + r] : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = tx * 4 + j;
        const float cn = c0 + cc < c_hi ? csq[c0 + cc] : 0.0f;
        Ss[r][cc] = __fsub_rn(__fsub_rn(2.0f * acc[i][j], qn), cn);
      }
    }
    __syncthreads();
    if (threadIdx.x < QB && q0 + threadIdx.x < Bq) {
      const int r = threadIdx.x;
      float* rv = lv + r * k;
      int* ri = li + r * k;
      const int ncols = min(CB, c_hi - c0);
      float worst = rv[k - 1];
      for (int cc = 0; cc < ncols; ++cc) {
        const float v = Ss[r][cc];
        if (v > worst) {
          int p = k - 1;
          while (p > 0 && rv[p - 1] < v) {
            rv[p] = rv[p - 1];
            ri[p] = ri[p - 1];
            --p;
          }
          rv[p] = v;
          ri[p] = c0 + cc;
          worst = rv[k - 1];
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < QB * k; i += NT) {
    const int r = i / k, j = i % k;
    if (q0 + r < Bq) {
      const size_t o = ((size_t)s * Bq + q0 + r) * k + j;
      pvals[o] = lv[i];
      pidx[o] = li[i];
    }
  }
}

__global__ void knn_merge_kernel(const float* __restrict__ pvals,
                                 const int* __restrict__ pidx,
                                 float* __restrict__ dist,   // (Bq, k)
                                 int* __restrict__ idx,      // (Bq, k)
                                 int Bq, int k, int S) {
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= Bq) return;
  int pos[256];
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
      if (bs < 0 || v > bv || (v == bv && i < bi)) {
        bs = s;
        bv = v;
        bi = i;
      }
    }
    ++pos[bs];
    dist[(size_t)qi * k + j] = sqrtf(fmaxf(-bv, 0.0f));
    idx[(size_t)qi * k + j] = bi;
  }
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// The largest k whose running lists fit in a block's shared memory on
// device `dev` (its opt-in limit), or a negative CUDA error.
extern "C" int vqacx_knn_kmax(int dev) {
  using namespace vqacx;
  int optin = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return static_cast<int>((optin - STATIC_SMEM) / list_smem(1));
}

// Scratch: pvals (S, Bq, k) f32 and pidx (S, Bq, k) int32, S =
// ceil(N / slice) <= 256; slice a multiple of 64; k <= vqacx_knn_kmax().
extern "C" int vqacx_knn(const void* q, const void* qsq, const void* c,
                         const void* csq, void* dist, void* idx, void* pvals,
                         void* pidx, int Bq, int N, int D, int k, int slice,
                         void* stream) {
  using namespace vqacx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = (N + slice - 1) / slice;
  const size_t smem = list_smem(k);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      knn_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  knn_partial_kernel<<<dim3((Bq + QB - 1) / QB, S), NT, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(qsq),
      static_cast<const float*>(c), static_cast<const float*>(csq),
      static_cast<float*>(pvals), static_cast<int*>(pidx), Bq, N, D, k,
      slice);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  knn_merge_kernel<<<(Bq + 127) / 128, 128, 0, st>>>(
      static_cast<const float*>(pvals), static_cast<const int*>(pidx),
      static_cast<float*>(dist), static_cast<int*>(idx), Bq, k, S);
  return static_cast<int>(cudaGetLastError());
}
