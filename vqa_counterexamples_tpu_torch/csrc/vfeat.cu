// Candidate image features with the gather inside the kernel (see
// ops/cuda/vfeat_kernel.py).
//
// GEMM rows are the B*K (example, candidate) pairs, row m = b*K + k, whose
// operand rows are gathered from the feature table by index.  Block tile:
// 64 rows x 64 output columns, two GEMMs (x and bf16(o*x)) sharing the row
// tiles.  8 warps: 4 along the rows (16 each) x 2 along the columns (32 =
// 2 fragments each).  Blocks with blockIdx.y == 0 also accumulate the f32
// squared distance of their rows.
#include "common.cuh"

namespace vqacx {
namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 8;
constexpr int LDC = BN + 4;
constexpr int NT = 256;
constexpr int SMEM_AB = 4 * BM * LDS * 2;   // x, o*x, W_other, W_mult tiles
constexpr int SMEM_C = 2 * BM * LDC * 4;    // two f32 output tiles
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;
constexpr float DIST_EPS = 1e-6f;
// the A-tile loads: BM rows x BK/8 chunks over NT threads, a fixed
// (row, chunk) per thread and pass
constexpr int CH = BK / 8;
constexpr int A_PASSES = BM * CH / NT;
static_assert(BM * CH % NT == 0, "A-tile chunks must divide over threads");
static_assert(NT % CH == 0, "a thread keeps one chunk column");

__global__ void __launch_bounds__(NT)
vfeat_fwd_kernel(const bf16* __restrict__ table, int N, int Dv,
                 const int* __restrict__ idx,        // (B, K+1)
                 int B, int K,
                 const bf16* __restrict__ wo,        // (H, Dv)
                 const bf16* __restrict__ wm,        // (H, Dv)
                 int H,
                 bf16* __restrict__ h_out,           // (B*K, H)
                 float* __restrict__ dist_out,       // (B*K,)
                 bool vec) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ int xrow[BM];
  __shared__ int orow[BM];
  bf16* Ax = reinterpret_cast<bf16*>(smem);
  bf16* Am = Ax + BM * LDS;
  bf16* Bo = Am + BM * LDS;
  bf16* Bm = Bo + BN * LDS;
  float* Co = reinterpret_cast<float*>(smem);  // reused after the K loop
  float* Cm = Co + BM * LDC;

  const int M = B * K;
  const int r0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wmi = warp % 4;
  const int wni = warp / 4;
  const bool with_dist = blockIdx.y == 0;

  for (int r = threadIdx.x; r < BM; r += NT) {
    const int m = r0 + r;
    if (m < M) {
      const int b = m / K;
      const int k = m % K;
      // clip like the reference gathers (indices are in range by
      // construction; this only keeps a bad index from faulting)
      xrow[r] = min(max(idx[(size_t)b * (K + 1) + 1 + k], 0), N - 1);
      orow[r] = min(max(idx[(size_t)b * (K + 1)], 0), N - 1);
    } else {
      xrow[r] = -1;
      orow[r] = -1;
    }
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[2], acc_m[2];
  for (int f = 0; f < 2; ++f) {
    wmma::fill_fragment(acc_o[f], 0.0f);
    wmma::fill_fragment(acc_m[f], 0.0f);
  }
  float dpart[A_PASSES];
  for (int p = 0; p < A_PASSES; ++p) dpart[p] = 0.0f;

  for (int k0 = 0; k0 < Dv; k0 += BK) {
    for (int p = 0; p < A_PASSES; ++p) {
      const int c = threadIdx.x + p * NT;
      const int r = c / CH;
      const int kc = (c % CH) * 8;
      const int gk = k0 + kc;
      const int xr = xrow[r];
      bf16* dx = Ax + r * LDS + kc;
      bf16* dm = Am + r * LDS + kc;
      if (xr >= 0 && vec && gk + 8 <= Dv) {
        Pack8 xv, ov, mv;
        xv.u = *reinterpret_cast<const uint4*>(table + (size_t)xr * Dv + gk);
        ov.u = *reinterpret_cast<const uint4*>(table + (size_t)orow[r] * Dv + gk);
        for (int e = 0; e < 8; ++e) {
          const float x = f32(lane8(xv, e));
          const float o = f32(lane8(ov, e));
          set_lane8(mv, e, rn(o * x));
          const float d = o - x + DIST_EPS;
          dpart[p] += d * d;
        }
        *reinterpret_cast<uint4*>(dx) = xv.u;
        *reinterpret_cast<uint4*>(dm) = mv.u;
      } else {
        for (int e = 0; e < 8; ++e) {
          bf16 xb = bf16_zero();
          bf16 mb = bf16_zero();
          if (xr >= 0 && gk + e < Dv) {
            xb = table[(size_t)xr * Dv + gk + e];
            const float x = f32(xb);
            const float o = f32(table[(size_t)orow[r] * Dv + gk + e]);
            mb = rn(o * x);
            const float d = o - x + DIST_EPS;
            dpart[p] += d * d;
          }
          dx[e] = xb;
          dm[e] = mb;
        }
      }
    }
    load_tile<BN, BK, LDS, NT>(Bo, wo, Dv, n0, H, k0, Dv, vec);
    load_tile<BN, BK, LDS, NT>(Bm, wm, Dv, n0, H, k0, Dv, vec);
    __syncthreads();
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fx, fm;
      wmma::load_matrix_sync(fx, Ax + (wmi * 16) * LDS + kk, LDS);
      wmma::load_matrix_sync(fm, Am + (wmi * 16) * LDS + kk, LDS);
      for (int f = 0; f < 2; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fb, Bo + (wni * 32 + f * 16) * LDS + kk, LDS);
        wmma::mma_sync(acc_o[f], fx, fb, acc_o[f]);
        wmma::load_matrix_sync(fb, Bm + (wni * 32 + f * 16) * LDS + kk, LDS);
        wmma::mma_sync(acc_m[f], fm, fb, acc_m[f]);
      }
    }
    __syncthreads();
  }

  for (int f = 0; f < 2; ++f) {
    wmma::store_matrix_sync(Co + (wmi * 16) * LDC + wni * 32 + f * 16,
                            acc_o[f], LDC, wmma::mem_row_major);
    wmma::store_matrix_sync(Cm + (wmi * 16) * LDC + wni * 32 + f * 16,
                            acc_m[f], LDC, wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BM * BN; i += NT) {
    const int r = i / BN;
    const int n = i % BN;
    const int m = r0 + r;
    const int gn = n0 + n;
    if (m < M && gn < H) {
      // each GEMM rounds its own output, then the sum rounds again
      const float ho = f32(rn(Co[r * LDC + n]));
      const float hm = f32(rn(Cm[r * LDC + n]));
      h_out[(size_t)m * H + gn] = rn(ho + hm);
    }
  }

  if (with_dist) {
    // the CH threads sharing a row are CH consecutive lanes of one warp
    for (int p = 0; p < A_PASSES; ++p) {
      float s = dpart[p];
      for (int off = CH / 2; off > 0; off /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      const int c = threadIdx.x + p * NT;
      const int m = r0 + c / CH;
      if (c % CH == 0 && m < M) dist_out[m] = sqrtf(s);
    }
  }
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

extern "C" int vqacx_vfeat_fwd(const void* table, int N, int Dv,
                               const void* idx, int B, int K, const void* wo,
                               const void* wm, int H, void* h_out,
                               void* dist_out, void* stream) {
  using vqacx::bf16;
  const bool vec = (Dv % 8 == 0) && vqacx::aligned16(table) &&
                   vqacx::aligned16(wo) && vqacx::aligned16(wm);
  const int M = B * K;
  const dim3 grid((M + vqacx::BM - 1) / vqacx::BM,
                  (H + vqacx::BN - 1) / vqacx::BN);
  vqacx::vfeat_fwd_kernel<<<grid, vqacx::NT, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(table), N, Dv, static_cast<const int*>(idx), B,
      K, static_cast<const bf16*>(wo), static_cast<const bf16*>(wm), H,
      static_cast<bf16*>(h_out), static_cast<float*>(dist_out), vec);
  return static_cast<int>(cudaGetLastError());
}
