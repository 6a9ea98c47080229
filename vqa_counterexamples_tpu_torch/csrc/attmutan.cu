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
// Backward, four launches, no atomics (reruns are bit-equal):
//   dx:    dx_v[b] = bf16(g[b] @ weff[b]^T); a block owns (example, 64
//          positions, 64 of Dh) and rebuilds its weff slice chunk by chunk;
//   w:     a block owns (64 of Dh, 64 of M, a contiguous group of examples)
//          and loops over its examples: dweff = x_v[b]^T g[b] (f32) on WMMA,
//          then dw[r] += dweff * hq[b, r] in shared memory and the partial
//          dhq[b, r, m] = sum over its 64 d of w[r, m, d] dweff[d, m];
//   dhq:   one thread per (b, m): gsum = sum_k g[b, k, m], then
//          dhq = bf16(sum of the d-tile partials + b3 * gsum);
//   dw_db: dw = the example groups' partials summed in group order;
//          db[r, m] = sum_b gsum[b, m] hq[b, r, m] in example order.
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

// ------------------------------------------------------------ backward: dx

__global__ void __launch_bounds__(NT)
attmutan_bwd_dx_kernel(const bf16* __restrict__ w,    // (R * M, Dh)
                       const bf16* __restrict__ hq,   // (B, R, M)
                       const bf16* __restrict__ g,    // (B, K, M)
                       bf16* __restrict__ dxv,        // (B, K, Dh)
                       int K, int Dh, int R, int M, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int MP = round_up(M, T);
  bf16* gs = reinterpret_cast<bf16*>(smem);          // [T k][LDS m]
  bf16* ws = gs + T * LDS;                           // [T d][LDS m] = weff
  float* Cs = reinterpret_cast<float*>(ws + T * LDS);  // [T k][LDC d]
  float* hq_s = Cs + T * LDC;                        // [R][MP]

  const int d0 = blockIdx.x * T;
  const int k0 = blockIdx.y * T;
  const int b = blockIdx.z;
  for (int i = threadIdx.x; i < R * MP; i += NT) {
    const int r = i / MP, m = i % MP;
    hq_s[i] = m < M ? f32(hq[((size_t)b * R + r) * M + m]) : 0.0f;
  }
  const bf16* gb = g + (size_t)b * K * M;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 2, wn = warp / 2;
  FragC acc[2][2];
  zero(acc);
  for (int mc = 0; mc < MP; mc += T) {
    __syncthreads();
    load_tile<T, T, LDS, NT>(gs, gb, M, k0, K, mc, M, vec);
    // this chunk of weff (64 of Dh x 64 of M), read along d
    for (int i = threadIdx.x; i < T * T; i += NT) {
      const int mm = i / T, dd = i % T;
      const int m = mc + mm, d = d0 + dd;
      float s = 0.0f;
      if (m < M && d < Dh)
        for (int r = 0; r < R; ++r)
          s = s + __fmul_rn(f32(w[((size_t)r * M + m) * Dh + d]),
                            hq_s[r * MP + m]);
      ws[dd * LDS + mm] = rn(s);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < T; kk += 16) {
      FragA fa[2];
      FragBc fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], gs + (wm * 32 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], ws + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  __syncthreads();
  store(acc, Cs);
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * NT;
    const int kk = i / T, dd = i % T;
    if (k0 + kk < K && d0 + dd < Dh)
      dxv[((size_t)b * K + k0 + kk) * Dh + d0 + dd] = rn(Cs[kk * LDC + dd]);
  }
}

// ------------------------------------------------------------- backward: w

__global__ void __launch_bounds__(NT)
attmutan_bwd_w_kernel(const bf16* __restrict__ xv,   // (B, K, Dh)
                      const bf16* __restrict__ w,    // (R * M, Dh)
                      const bf16* __restrict__ hq,   // (B, R, M)
                      const bf16* __restrict__ g,    // (B, K, M)
                      float* __restrict__ pdw,       // (G, R * M, Dh)
                      float* __restrict__ pdhq,      // (DT, B, R, M)
                      int B, int K, int Dh, int R, int M, int per_group,
                      bool vec_x, bool vec_g) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);            // [T k][LDS d]
  bf16* gs = xs + T * LDS;                             // [T k][LDS m]
  bf16* wt = gs + T * LDS;                             // [R][T d][LDS m]
  float* Cs = reinterpret_cast<float*>(wt + R * T * LDS);  // [T d][LDC m]
  float* acc_dw = Cs + T * LDC;                        // [R][T d][T m]
  float* hq_s = acc_dw + R * T * T;                    // [R][T m]

  const int d0 = blockIdx.x * T;
  const int m0 = blockIdx.y * T;
  const int grp = blockIdx.z;
  const int b_lo = grp * per_group;
  const int b_hi = min(B, b_lo + per_group);
  const int dtile = blockIdx.x;

  for (int i = threadIdx.x; i < R * T * T; i += NT) {
    const int r = i / (T * T), mm = (i / T) % T, dd = i % T;
    const int m = m0 + mm, d = d0 + dd;
    wt[(r * T + dd) * LDS + mm] =
        (m < M && d < Dh) ? w[((size_t)r * M + m) * Dh + d] : bf16_zero();
    acc_dw[i] = 0.0f;
  }
  const int warp = threadIdx.x / 32;
  const int wm = warp % 2, wn = warp / 2;
  for (int b = b_lo; b < b_hi; ++b) {
    for (int i = threadIdx.x; i < R * T; i += NT) {
      const int r = i / T, m = m0 + i % T;
      hq_s[i] = m < M ? f32(hq[((size_t)b * R + r) * M + m]) : 0.0f;
    }
    // dweff tile (64 of Dh x 64 of M) = x_v[b]^T g[b], summed over K
    FragC acc[2][2];
    zero(acc);
    for (int k0 = 0; k0 < K; k0 += T) {
      __syncthreads();
      load_tile<T, T, LDS, NT>(xs, xv + (size_t)b * K * Dh, Dh, k0, K, d0,
                               Dh, vec_x);
      load_tile<T, T, LDS, NT>(gs, g + (size_t)b * K * M, M, k0, K, m0, M,
                               vec_g);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < T; kk += 16) {
        FragAc fa[2];
        FragBr fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], xs + kk * LDS + wm * 32 + i * 16, LDS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], gs + kk * LDS + wn * 32 + j * 16, LDS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    store(acc, Cs);
    __syncthreads();
    // dw[r] += dweff * hq[b, r]: each thread owns its elements
    for (int i = threadIdx.x; i < T * T; i += NT) {
      const float v = Cs[(i / T) * LDC + i % T];
      for (int r = 0; r < R; ++r)
        acc_dw[r * T * T + i] += __fmul_rn(v, hq_s[r * T + i % T]);
    }
    // this d-tile's part of dhq[b, r, m] = sum_d w[r, m, d] dweff[d, m]
    for (int p = threadIdx.x; p < R * T; p += NT) {
      const int r = p / T, mm = p % T;
      if (m0 + mm < M) {
        float s = 0.0f;
        for (int dd = 0; dd < T; ++dd)
          s = s + __fmul_rn(f32(wt[(r * T + dd) * LDS + mm]),
                            Cs[dd * LDC + mm]);
        pdhq[(((size_t)dtile * B + b) * R + r) * M + m0 + mm] = s;
      }
    }
    __syncthreads();
  }
  __syncthreads();
  // this group's partial dw, written along d
  float* out = pdw + (size_t)grp * R * M * Dh;
  for (int i = threadIdx.x; i < R * T * T; i += NT) {
    const int r = i / (T * T), mm = (i / T) % T, dd = i % T;
    const int m = m0 + mm, d = d0 + dd;
    if (m < M && d < Dh)
      out[((size_t)r * M + m) * Dh + d] = acc_dw[(r * T + dd) * T + mm];
  }
}

// ------------------------------------------------- backward: dhq, dw, db

__global__ void attmutan_bwd_dhq_kernel(const bf16* __restrict__ b3,
                                        const bf16* __restrict__ g,
                                        const float* __restrict__ pdhq,
                                        float* __restrict__ gsum,
                                        bf16* __restrict__ dhq,
                                        int B, int K, int R, int M, int DT) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * M) return;
  const int b = i / M, m = i % M;
  float gs = 0.0f;
  for (int k = 0; k < K; ++k) gs += f32(g[((size_t)b * K + k) * M + m]);
  gsum[i] = gs;
  for (int r = 0; r < R; ++r) {
    float s = 0.0f;
    for (int dt = 0; dt < DT; ++dt)
      s += pdhq[(((size_t)dt * B + b) * R + r) * M + m];
    dhq[((size_t)b * R + r) * M + m] =
        rn(s + __fmul_rn(f32(b3[(size_t)r * M + m]), gs));
  }
}

__global__ void attmutan_bwd_dw_db_kernel(const bf16* __restrict__ hq,
                                          const float* __restrict__ gsum,
                                          const float* __restrict__ pdw,
                                          float* __restrict__ dw,
                                          float* __restrict__ db,
                                          int B, int R, int M, int Dh,
                                          int G) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = (size_t)R * M * Dh;
  if (i < n) {
    float s = 0.0f;
    for (int grp = 0; grp < G; ++grp) s += pdw[(size_t)grp * n + i];
    dw[i] = s;
  }
  if (i < (size_t)R * M) {
    const int r = (int)(i / M), m = (int)(i % M);
    float s = 0.0f;
    for (int b = 0; b < B; ++b)
      s += __fmul_rn(gsum[(size_t)b * M + m],
                     f32(hq[((size_t)b * R + r) * M + m]));
    db[i] = s;
  }
}

size_t fwd_smem(int Dh, int R) {
  return (size_t)T * (round_up(Dh, T) + 8) * sizeof(bf16) +
         (size_t)T * LDS * sizeof(bf16) + (size_t)T * LDC * sizeof(float) +
         (size_t)(R + 1) * T * sizeof(float);
}

size_t dx_smem(int M, int R) {
  return (size_t)2 * T * LDS * sizeof(bf16) + (size_t)T * LDC * sizeof(float) +
         (size_t)R * round_up(M, T) * sizeof(float);
}

size_t w_smem(int R) {
  return (size_t)(2 + R) * T * LDS * sizeof(bf16) +
         (size_t)T * LDC * sizeof(float) +
         (size_t)R * T * T * sizeof(float) + (size_t)R * T * sizeof(float);
}

int set_smem(const void* fn, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// Shared memory the launches need (bytes), for the wrapper's checks.
extern "C" size_t vqacx_attmutan_smem(int which, int Dh, int R, int M) {
  return which == 0 ? vqacx::fwd_smem(Dh, R)
         : which == 1 ? vqacx::dx_smem(M, R)
                      : vqacx::w_smem(R);
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

// Scratch (f32): pdw (G, R * M, Dh), pdhq (ceil(Dh / 64), B, R, M), gsum
// (B, M); G = ceil(B / per_group).
extern "C" int vqacx_attmutan_bwd(const void* xv, const void* w,
                                  const void* b3, const void* hq,
                                  const void* g, void* dxv, void* dhq,
                                  void* dw, void* db, void* pdw, void* pdhq,
                                  void* gsum, int B, int K, int Dh, int R,
                                  int M, int per_group, void* stream) {
  using namespace vqacx;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xv_ = static_cast<const bf16*>(xv);
  const bf16* w_ = static_cast<const bf16*>(w);
  const bf16* hq_ = static_cast<const bf16*>(hq);
  const bf16* g_ = static_cast<const bf16*>(g);
  const bool vec_x = (Dh % 8 == 0) && aligned16(xv);
  const bool vec_g = (M % 8 == 0) && aligned16(g);
  const int DT = (Dh + T - 1) / T;
  const int MT = (M + T - 1) / T;
  const int G = (B + per_group - 1) / per_group;

  size_t smem = dx_smem(M, R);
  int rc = set_smem(reinterpret_cast<const void*>(attmutan_bwd_dx_kernel),
                    smem);
  if (rc != 0) return rc;
  attmutan_bwd_dx_kernel<<<dim3(DT, (K + T - 1) / T, B), NT, smem, st>>>(
      w_, hq_, g_, static_cast<bf16*>(dxv), K, Dh, R, M, vec_g);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  smem = w_smem(R);
  rc = set_smem(reinterpret_cast<const void*>(attmutan_bwd_w_kernel), smem);
  if (rc != 0) return rc;
  attmutan_bwd_w_kernel<<<dim3(DT, MT, G), NT, smem, st>>>(
      xv_, w_, hq_, g_, static_cast<float*>(pdw), static_cast<float*>(pdhq),
      B, K, Dh, R, M, per_group, vec_x, vec_g);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  attmutan_bwd_dhq_kernel<<<(B * M + 255) / 256, 256, 0, st>>>(
      static_cast<const bf16*>(b3), g_, static_cast<const float*>(pdhq),
      static_cast<float*>(gsum), static_cast<bf16*>(dhq), B, K, R, M, DT);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  const size_t n = (size_t)R * M * Dh;
  attmutan_bwd_dw_db_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      hq_, static_cast<const float*>(gsum), static_cast<const float*>(pdw),
      static_cast<float*>(dw), static_cast<float*>(db), B, R, M, Dh, G);
  return static_cast<int>(cudaGetLastError());
}
