// GRU recurrence, one launch per timestep (see ops/cuda/gru_kernel.py).
//
// Block tile: 64 batch rows x 32 hidden units.  The GEMM columns of a block
// are the three gates' rows of W_hh for its units (96 columns), so the gate
// epilogue has everything it needs locally.  8 warps: 4 along the batch
// rows (16 each) x 2 along the 96 columns (48 = 3 fragments each).
#include "common.cuh"

namespace vqacx {
namespace {

constexpr int BM = 64;          // batch rows per block
constexpr int BJ = 32;          // hidden units per block
constexpr int BN = 3 * BJ;      // GEMM columns per block (r, z, n)
constexpr int BK = 64;
constexpr int LDS = BK + 8;
constexpr int LDC = BN + 4;
constexpr int NT = 256;
constexpr int SMEM_AB = (BM + BN) * LDS * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// h_prev == nullptr means t == 0 (h_{-1} = 0, so h_proj = b_hh).
// mask == nullptr means ones.
__global__ void __launch_bounds__(NT)
gru_step_kernel(const bf16* __restrict__ xp_t,     // (B, 3H)
                const bf16* __restrict__ w,        // (3H, H)
                const float* __restrict__ b,       // (3H,)
                const bf16* __restrict__ mask,     // (B, H) or null
                const bf16* __restrict__ h_prev,   // (B, H) or null
                bf16* __restrict__ h_out,          // (B, H)
                bf16* __restrict__ hproj_t,        // (B, 3H) or null
                int B, int H, bool vec) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int j0 = blockIdx.x * BJ;
  const int b0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3];
  for (int f = 0; f < 3; ++f) wmma::fill_fragment(acc[f], 0.0f);

  if (h_prev != nullptr) {
    for (int k0 = 0; k0 < H; k0 += BK) {
      // A tile: bf16(h * mask)
      for (int c = threadIdx.x; c < BM * (BK / 8); c += NT) {
        const int r = c / (BK / 8);
        const int kc = (c % (BK / 8)) * 8;
        const int gb = b0 + r;
        const int gk = k0 + kc;
        bf16* dst = As + r * LDS + kc;
        if (gb < B && vec && gk + 8 <= H) {
          Pack8 hv, out;
          hv.u = *reinterpret_cast<const uint4*>(h_prev + (size_t)gb * H + gk);
          if (mask != nullptr) {
            Pack8 mv;
            mv.u = *reinterpret_cast<const uint4*>(mask + (size_t)gb * H + gk);
            for (int e = 0; e < 8; ++e)
              set_lane8(out, e, rn(f32(lane8(hv, e)) * f32(lane8(mv, e))));
          } else {
            out = hv;
          }
          *reinterpret_cast<uint4*>(dst) = out.u;
        } else {
          for (int e = 0; e < 8; ++e) {
            bf16 v = bf16_zero();
            if (gb < B && gk + e < H) {
              const size_t i = (size_t)gb * H + gk + e;
              v = mask != nullptr ? rn(f32(h_prev[i]) * f32(mask[i]))
                                  : h_prev[i];
            }
            dst[e] = v;
          }
        }
      }
      // B tile: W rows g*H + j0 + jj for the three gates
      for (int c = threadIdx.x; c < BN * (BK / 8); c += NT) {
        const int n = c / (BK / 8);
        const int kc = (c % (BK / 8)) * 8;
        const int gate = n / BJ;
        const int j = j0 + n % BJ;
        const int gk = k0 + kc;
        bf16* dst = Bs + n * LDS + kc;
        const bf16* src = w + ((size_t)gate * H + j) * H + gk;
        if (j < H && vec && gk + 8 <= H) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8; ++e)
            dst[e] = (j < H && gk + e < H) ? src[e] : bf16_zero();
        }
      }
      __syncthreads();
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (wm * 16) * LDS + kk, LDS);
        for (int f = 0; f < 3; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Bs + (wn * 48 + f * 16) * LDS + kk, LDS);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
      __syncthreads();
    }
  }
  for (int f = 0; f < 3; ++f)
    wmma::store_matrix_sync(Cs + (wm * 16) * LDC + wn * 48 + f * 16, acc[f],
                            LDC, wmma::mem_row_major);
  __syncthreads();

  const size_t h3 = (size_t)3 * H;
  for (int i = threadIdx.x; i < BM * BJ; i += NT) {
    const int r = i / BJ;
    const int jj = i % BJ;
    const int gb = b0 + r;
    const int j = j0 + jj;
    if (gb >= B || j >= H) continue;
    const float hr = Cs[r * LDC + jj] + b[j];
    const float hz = Cs[r * LDC + BJ + jj] + b[H + j];
    const float hn = Cs[r * LDC + 2 * BJ + jj] + b[2 * H + j];
    const bf16* xrow = xp_t + gb * h3;
    const float rg = sigmoid(f32(xrow[j]) + hr);
    const float zg = sigmoid(f32(xrow[H + j]) + hz);
    const float ng = tanhf(f32(xrow[2 * H + j]) + rg * hn);
    const float h_old = h_prev != nullptr ? f32(h_prev[(size_t)gb * H + j]) : 0.0f;
    h_out[(size_t)gb * H + j] = rn((1.0f - zg) * ng + zg * h_old);
    if (hproj_t != nullptr) {
      bf16* hrow = hproj_t + gb * h3;
      hrow[j] = rn(hr);
      hrow[H + j] = rn(hz);
      hrow[2 * H + j] = rn(hn);
    }
  }
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// states[t] = GRU step of states[t-1] (states[-1] = 0) for t in [0, T).
extern "C" int vqacx_gru_fwd(const void* xp, const void* w, const void* b,
                             const void* mask, void* states, void* hproj,
                             int T, int B, int H, void* stream) {
  using vqacx::bf16;
  const bf16* xp_ = static_cast<const bf16*>(xp);
  const bf16* w_ = static_cast<const bf16*>(w);
  const float* b_ = static_cast<const float*>(b);
  const bf16* mask_ = static_cast<const bf16*>(mask);
  bf16* states_ = static_cast<bf16*>(states);
  bf16* hproj_ = static_cast<bf16*>(hproj);
  const bool vec = (H % 8 == 0) && vqacx::aligned16(w) &&
                   vqacx::aligned16(states) &&
                   (mask == nullptr || vqacx::aligned16(mask));
  const dim3 grid((H + vqacx::BJ - 1) / vqacx::BJ,
                  (B + vqacx::BM - 1) / vqacx::BM);
  const size_t step_h = (size_t)B * H;
  const size_t step_x = (size_t)B * 3 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    vqacx::gru_step_kernel<<<grid, vqacx::NT, 0, s>>>(
        xp_ + t * step_x, w_, b_, mask_,
        t > 0 ? states_ + (t - 1) * step_h : nullptr, states_ + t * step_h,
        hproj_ != nullptr ? hproj_ + t * step_x : nullptr, B, H, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
