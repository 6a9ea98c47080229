// Frozen answer head + softmax in three sweeps over a block's rows (see
// ops/cuda/mixture_kernel.py).
//
// Block: 64 rows, 8 warps.  GEMM tile 64 rows x 64 answers (4 warps along
// the rows x 2 along the answers, 2 fragments each).  For the elementwise
// sweeps warp w owns rows 8w .. 8w+7 and lane l the answers a with
// a % 32 == l, so every element a thread reads in sweeps 2 and 3 is one it
// wrote in sweep 1 (no exchange between threads) and a warp touches 32
// consecutive answers of a row at a time.
#include "common.cuh"

namespace vqacx {
namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 8;
constexpr int LDC = BN + 4;
constexpr int NT = 256;
constexpr int ROWS_PER_WARP = BM / (NT / 32);
constexpr int SMEM_AB = (BM + BN) * LDS * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

__global__ void __launch_bounds__(NT)
mixture_fwd_kernel(const bf16* __restrict__ z,     // (M, D)
                   int M, int D,
                   const bf16* __restrict__ w,     // (A, D)
                   const bf16* __restrict__ bias,  // (A,)
                   int A,
                   bf16* __restrict__ out,         // (M, A)
                   bool vec) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);  // reused per answer tile

  const int r0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wmi = warp % 4;
  const int wni = warp / 4;

  float rmax[ROWS_PER_WARP];
  for (int i = 0; i < ROWS_PER_WARP; ++i) rmax[i] = __int_as_float(static_cast<int>(0xff800000u));

  // sweep 1: l = bf16(bf16(z @ W^T) + b), stored; running row max
  for (int n0 = 0; n0 < A; n0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int k0 = 0; k0 < D; k0 += BK) {
      load_tile<BM, BK, LDS, NT>(As, z, D, r0, M, k0, D, vec);
      load_tile<BN, BK, LDS, NT>(Bs, w, D, n0, A, k0, D, vec);
      __syncthreads();
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (wmi * 16) * LDS + kk, LDS);
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Bs + (wni * 32 + f * 16) * LDS + kk, LDS);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
      __syncthreads();
    }
    for (int f = 0; f < 2; ++f)
      wmma::store_matrix_sync(Cs + (wmi * 16) * LDC + wni * 32 + f * 16,
                              acc[f], LDC, wmma::mem_row_major);
    __syncthreads();
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const int m = r0 + r;
      for (int c = lane; c < BN; c += 32) {
        const int a = n0 + c;
        if (m < M && a < A) {
          const bf16 l = rn(f32(rn(Cs[r * LDC + c])) + f32(bias[a]));
          out[(size_t)m * A + a] = l;
          rmax[i] = fmaxf(rmax[i], f32(l));
        }
      }
    }
    __syncthreads();  // Cs aliases the next tile's operand buffers
  }

  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int m = r0 + warp * ROWS_PER_WARP + i;
    if (m >= M) continue;  // uniform across the warp
    float mx = rmax[i];
    for (int off = 16; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    bf16* row = out + (size_t)m * A;
    // sweep 2: u = bf16(exp(bf16(l - max))) in place, f32 row sum
    float s = 0.0f;
    for (int a = lane; a < A; a += 32) {
      const bf16 u = rn(expf(f32(rn(f32(row[a]) - mx))));
      row[a] = u;
      s += f32(u);
    }
    for (int off = 16; off > 0; off /= 2)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    // sweep 3: scale by the bf16 reciprocal of the sum
    const float inv = f32(rn(1.0f / s));
    for (int a = lane; a < A; a += 32) row[a] = rn(f32(row[a]) * inv);
  }
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

extern "C" int vqacx_mixture_fwd(const void* z, int M, int D, const void* w,
                                 const void* bias, int A, void* out,
                                 void* stream) {
  using vqacx::bf16;
  const bool vec =
      (D % 8 == 0) && vqacx::aligned16(z) && vqacx::aligned16(w);
  const dim3 grid((M + vqacx::BM - 1) / vqacx::BM);
  vqacx::mixture_fwd_kernel<<<grid, vqacx::NT, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(z), M, D, static_cast<const bf16*>(w),
      static_cast<const bf16*>(bias), A, static_cast<bf16*>(out), vec);
  return static_cast<int>(cudaGetLastError());
}
