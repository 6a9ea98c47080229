// MUTAN's rank-R Tucker fusion (see ops/cuda/mutan_kernel.py):
//   out = sum_r (x_v @ Wv_r^T + bv_r) * (x_q @ Wq_r^T + bq_r)
// with neither (B, R * dmm) projection leaving the block.
//
// Block tile: 32 batch rows x 32 output columns (dmm).  For each rank r the
// block runs the two projections of its tile in one K loop (128 deep) on
// bf16 WMMA fragments with f32 accumulators, adds the f32 biases and
// accumulates the product into registers; the output is written once, in
// f32.  4 warps: 2 along the rows x 2 along the columns, one 16 x 16
// fragment of each projection per warp.
#include "common.cuh"

namespace vqacx {
namespace {

constexpr int BM = 32;
constexpr int BN = 32;
constexpr int BK = 128;
constexpr int LDS = BK + 8;
constexpr int LDC = BN + 4;
constexpr int NT = 128;
constexpr int PER = BM * BN / NT;   // epilogue elements per thread

__global__ void __launch_bounds__(NT)
mutan_fwd_kernel(const bf16* __restrict__ xv,    // (B, dhv)
                 const bf16* __restrict__ xq,    // (B, dhq)
                 const bf16* __restrict__ wv,    // (R * dmm, dhv)
                 const float* __restrict__ bv,   // (R * dmm,)
                 const bf16* __restrict__ wq,    // (R * dmm, dhq)
                 const float* __restrict__ bq,   // (R * dmm,)
                 float* __restrict__ out,        // (B, dmm)
                 int B, int dhv, int dhq, int R, int dmm, bool vec_v,
                 bool vec_q) {
  using namespace nvcuda;
  // x_v, W_v, x_q, W_q tiles, then the two f32 projection tiles
  __shared__ __align__(128) bf16 Av[BM * LDS];
  __shared__ __align__(128) bf16 Bv[BN * LDS];
  __shared__ __align__(128) bf16 Aq[BM * LDS];
  __shared__ __align__(128) bf16 Bq[BN * LDS];
  __shared__ __align__(128) float Cv[BM * LDC];
  __shared__ __align__(128) float Cq[BM * LDC];

  const int n0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 2;
  const int wn = warp / 2;
  const int kmax = dhv > dhq ? dhv : dhq;

  float acc_out[PER];
#pragma unroll
  for (int e = 0; e < PER; ++e) acc_out[e] = 0.0f;

  for (int r = 0; r < R; ++r) {
    const bf16* wv_r = wv + (size_t)r * dmm * dhv;
    const bf16* wq_r = wq + (size_t)r * dmm * dhq;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hv, hq;
    wmma::fill_fragment(hv, 0.0f);
    wmma::fill_fragment(hq, 0.0f);
    // both projections in one K loop (tiles past a side's width are 0)
    for (int k0 = 0; k0 < kmax; k0 += BK) {
      load_tile<BM, BK, LDS, NT>(Av, xv, dhv, b0, B, k0, dhv, vec_v);
      load_tile<BN, BK, LDS, NT>(Bv, wv_r, dhv, n0, dmm, k0, dhv, vec_v);
      load_tile<BM, BK, LDS, NT>(Aq, xq, dhq, b0, B, k0, dhq, vec_q);
      load_tile<BN, BK, LDS, NT>(Bq, wq_r, dhq, n0, dmm, k0, dhq, vec_q);
      __syncthreads();
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Av + (wm * 16) * LDS + kk, LDS);
        wmma::load_matrix_sync(fb, Bv + (wn * 16) * LDS + kk, LDS);
        wmma::mma_sync(hv, fa, fb, hv);
        wmma::load_matrix_sync(fa, Aq + (wm * 16) * LDS + kk, LDS);
        wmma::load_matrix_sync(fb, Bq + (wn * 16) * LDS + kk, LDS);
        wmma::mma_sync(hq, fa, fb, hq);
      }
      __syncthreads();
    }
    wmma::store_matrix_sync(Cv + (wm * 16) * LDC + wn * 16, hv, LDC,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(Cq + (wm * 16) * LDC + wn * 16, hq, LDC,
                            wmma::mem_row_major);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = threadIdx.x + e * NT;
      const int row = i / BN;
      const int col = i % BN;
      const int m = n0 + col;
      if (b0 + row < B && m < dmm) {
        const size_t bi = (size_t)r * dmm + m;
        acc_out[e] += (Cv[row * LDC + col] + bv[bi]) *
                      (Cq[row * LDC + col] + bq[bi]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = threadIdx.x + e * NT;
    const int gb = b0 + i / BN;
    const int m = n0 + i % BN;
    if (gb < B && m < dmm) out[(size_t)gb * dmm + m] = acc_out[e];
  }
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

extern "C" int vqacx_mutan_fwd(const void* xv, const void* xq, const void* wv,
                               const void* bv, const void* wq, const void* bq,
                               void* out, int B, int dhv, int dhq, int R,
                               int dmm, void* stream) {
  using vqacx::bf16;
  const bool vec_v = (dhv % 8 == 0) && vqacx::aligned16(xv) &&
                     vqacx::aligned16(wv);
  const bool vec_q = (dhq % 8 == 0) && vqacx::aligned16(xq) &&
                     vqacx::aligned16(wq);
  const dim3 grid((dmm + vqacx::BN - 1) / vqacx::BN,
                  (B + vqacx::BM - 1) / vqacx::BM);
  vqacx::mutan_fwd_kernel<<<grid, vqacx::NT, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xv), static_cast<const bf16*>(xq),
      static_cast<const bf16*>(wv), static_cast<const float*>(bv),
      static_cast<const bf16*>(wq), static_cast<const float*>(bq),
      static_cast<float*>(out), B, dhv, dhq, R, dmm, vec_v, vec_q);
  return static_cast<int>(cudaGetLastError());
}
