// GRU recurrence, one launch per timestep (see ops/cuda/gru_kernel.py):
// the forward (shared or per-gate variational masks) and the backward's
// reverse sweep.
//
// Forward block tile: 64 batch rows x 32 hidden units.  The GEMM columns of
// a block are the three gates' rows of W_hh for its units (96 columns), so
// the gate epilogue has everything it needs locally.  8 warps: 4 along the
// batch rows (16 each) x 2 along the 96 columns (48 = 3 fragments each).
// With per-gate masks (NG = 3) the block builds three A tiles,
// bf16(h * mask_g), one per gate; a 16-column fragment lies inside one
// gate's 32 columns, so each fragment reads its own gate's tile.
//
// Backward, per timestep t (reverse): a gate kernel (one thread per (b, j))
// recomputes r, z, n from the bf16 residuals, emits the gate cotangents and
// leaves g * z in the f32 carry dh; then, for t > 0, a GEMM kernel adds
// sum_g bf16(dh_proj_g) @ W_g * mask_g to dh.  Its block tile is 64 batch
// rows x 64 hidden units, the gates one after the other; 8 warps: 4 along
// the rows x 2 along the columns (32 = 2 fragments each).
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
constexpr int SMEM_C = BM * LDC * 4;

__host__ __device__ constexpr int smem_fwd(int ng) {
  return (ng * BM + BN) * LDS * 2 > SMEM_C ? (ng * BM + BN) * LDS * 2
                                           : SMEM_C;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// h_prev == nullptr means t == 0 (h_{-1} = 0, so h_proj = b_hh).
// mask == nullptr means ones (NG == 1 only).  NG == 3: mask is (3, B, H),
// gate g at mask + g * B * H.
template <int NG>
__global__ void __launch_bounds__(NT)
gru_step_kernel(const bf16* __restrict__ xp_t,     // (B, 3H)
                const bf16* __restrict__ w,        // (3H, H)
                const float* __restrict__ b,       // (3H,)
                const bf16* __restrict__ mask,     // (NG, B, H) or null
                const bf16* __restrict__ h_prev,   // (B, H) or null
                bf16* __restrict__ h_out,          // (B, H)
                bf16* __restrict__ hproj_t,        // (B, 3H) or null
                int B, int H, bool vec) {
  using namespace nvcuda;
  constexpr int SMEM = smem_fwd(NG);
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);        // NG tiles of BM x LDS
  bf16* Bs = As + NG * BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int j0 = blockIdx.x * BJ;
  const int b0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;
  const size_t gstride = (size_t)B * H;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[3];
  for (int f = 0; f < 3; ++f) wmma::fill_fragment(acc[f], 0.0f);

  if (h_prev != nullptr) {
    for (int k0 = 0; k0 < H; k0 += BK) {
      // A tile(s): bf16(h * mask_g)
      for (int c = threadIdx.x; c < BM * (BK / 8); c += NT) {
        const int r = c / (BK / 8);
        const int kc = (c % (BK / 8)) * 8;
        const int gb = b0 + r;
        const int gk = k0 + kc;
        const size_t i0 = (size_t)gb * H + gk;
        if (gb < B && vec && gk + 8 <= H) {
          Pack8 hv;
          hv.u = *reinterpret_cast<const uint4*>(h_prev + i0);
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            Pack8 out;
            if (mask != nullptr) {
              Pack8 mv;
              mv.u = *reinterpret_cast<const uint4*>(mask + g * gstride + i0);
              for (int e = 0; e < 8; ++e)
                set_lane8(out, e, rn(f32(lane8(hv, e)) * f32(lane8(mv, e))));
            } else {
              out = hv;
            }
            *reinterpret_cast<uint4*>(As + g * BM * LDS + r * LDS + kc) =
                out.u;
          }
        } else {
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            bf16* dst = As + g * BM * LDS + r * LDS + kc;
            for (int e = 0; e < 8; ++e) {
              bf16 v = bf16_zero();
              if (gb < B && gk + e < H) {
                const size_t i = i0 + e;
                v = mask != nullptr
                        ? rn(f32(h_prev[i]) * f32(mask[g * gstride + i]))
                        : h_prev[i];
              }
              dst[e] = v;
            }
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
        if constexpr (NG == 1)
          wmma::load_matrix_sync(fa, As + (wm * 16) * LDS + kk, LDS);
        for (int f = 0; f < 3; ++f) {
          if constexpr (NG == 3) {
            const int gate = (wn * 48 + f * 16) / BJ;
            wmma::load_matrix_sync(
                fa, As + gate * BM * LDS + (wm * 16) * LDS + kk, LDS);
          }
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

// ---------------------------------------------------------------- backward

// One reverse timestep's gate cotangents, elementwise over (b, j):
//   g = ds + dh;  dxp = bf16([dsr, dsz, dsn]);  dh_proj = bf16([dsr, dsz,
//   dhn]);  dh <- g * z   (the back term is added by the GEMM kernel).
// h_prev == nullptr means t == 0.
__global__ void __launch_bounds__(NT)
gru_bwd_gate_kernel(const bf16* __restrict__ ds_t,     // (B, H)
                    const bf16* __restrict__ xp_t,     // (B, 3H)
                    const bf16* __restrict__ hp_t,     // (B, 3H)
                    const bf16* __restrict__ h_prev,   // (B, H) or null
                    float* __restrict__ dh,            // (B, H) in / out
                    bf16* __restrict__ dxp_t,          // (B, 3H)
                    bf16* __restrict__ dhp_t,          // (B, 3H)
                    int B, int H) {
  const size_t n = (size_t)B * H;
  const size_t h3 = (size_t)3 * H;
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += (size_t)gridDim.x * NT) {
    const size_t bb = i / H;
    const size_t j = i % H;
    const size_t x0 = bb * h3 + j;
    const float g = f32(ds_t[i]) + dh[i];
    const float hn = f32(hp_t[x0 + 2 * H]);
    const float r = sigmoid(f32(xp_t[x0]) + f32(hp_t[x0]));
    const float z = sigmoid(f32(xp_t[x0 + H]) + f32(hp_t[x0 + H]));
    const float nn = tanhf(f32(xp_t[x0 + 2 * H]) + r * hn);
    const float hprev = h_prev != nullptr ? f32(h_prev[i]) : 0.0f;
    const float dn = g * (1.0f - z);
    const float dsz = g * (hprev - nn) * z * (1.0f - z);
    const float dsn = dn * (1.0f - nn * nn);
    const float dhn = dsn * r;
    const float dsr = dsn * hn * r * (1.0f - r);
    dxp_t[x0] = rn(dsr);
    dxp_t[x0 + H] = rn(dsz);
    dxp_t[x0 + 2 * H] = rn(dsn);
    dhp_t[x0] = rn(dsr);
    dhp_t[x0 + H] = rn(dsz);
    dhp_t[x0 + 2 * H] = rn(dhn);
    dh[i] = g * z;
  }
}

constexpr int KBM = 64;          // batch rows per block
constexpr int KBN = 64;          // hidden units (k) per block
constexpr int KBK = 64;          // depth (j) per tile
constexpr int KLDA = KBK + 8;
constexpr int KLDB = KBN + 8;
constexpr int KLDC = KBN + 4;
constexpr int KSMEM_AB = (KBM * KLDA + KBK * KLDB) * 2;
constexpr int KSMEM_C = KBM * KLDC * 4;
constexpr int KSMEM = KSMEM_AB > KSMEM_C ? KSMEM_AB : KSMEM_C;

// dh[b, k] += sum_g (bf16(dh_proj_g) @ W_g)[b, k] * mask_g[b, k], in gate
// order r, z, n, where W_g = W_hh[g*H:(g+1)*H] (rows j, columns k).
// mask == nullptr means ones; gstride is 0 for one shared (B, H) mask.
// The gates run one after the other, each folded into dh before the next
// (the order of JAX's sum), so a block holds one gate's accumulators.
__global__ void __launch_bounds__(NT)
gru_bwd_back_kernel(const bf16* __restrict__ dhp_t,   // (B, 3H)
                    const bf16* __restrict__ w,       // (3H, H)
                    const bf16* __restrict__ mask,    // (B, H) / (3, B, H)
                    size_t gstride,
                    float* __restrict__ dh,           // (B, H) in / out
                    int B, int H, bool vec) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[KSMEM];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + KBM * KLDA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after each K loop

  const int k0n = blockIdx.x * KBN;
  const int b0 = blockIdx.y * KBM;
  const int warp = threadIdx.x / 32;
  const int wm = warp % 4;
  const int wn = warp / 4;

  for (int g = 0; g < 3; ++g) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
    for (int j0 = 0; j0 < H; j0 += KBK) {
      // A: dh_proj_g rows b, columns j; B: W_g rows j, columns k
      load_tile<KBM, KBK, KLDA, NT>(As, dhp_t + (size_t)g * H, 3 * H, b0, B,
                                    j0, H, vec);
      load_tile<KBK, KBN, KLDB, NT>(Bs, w + (size_t)g * H * H, H, j0, H,
                                    k0n, H, vec);
      __syncthreads();
      for (int kk = 0; kk < KBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, As + (wm * 16) * KLDA + kk, KLDA);
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, Bs + kk * KLDB + wn * 32 + f * 16, KLDB);
          wmma::mma_sync(acc[f], fa, fb, acc[f]);
        }
      }
      __syncthreads();
    }
    for (int f = 0; f < 2; ++f)
      wmma::store_matrix_sync(Cs + (wm * 16) * KLDC + wn * 32 + f * 16,
                              acc[f], KLDC, wmma::mem_row_major);
    __syncthreads();
    // each thread owns the same (row, column) elements for every gate
    for (int i = threadIdx.x; i < KBM * KBN; i += NT) {
      const int r = i / KBN;
      const int c = i % KBN;
      const int gb = b0 + r;
      const int k = k0n + c;
      if (gb < B && k < H) {
        const size_t o = (size_t)gb * H + k;
        const float m = mask != nullptr ? f32(mask[g * gstride + o]) : 1.0f;
        dh[o] = dh[o] + Cs[r * KLDC + c] * m;
      }
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// states[t] = GRU step of states[t-1] (states[-1] = 0) for t in [0, T).
// mask_gates: 0 (no mask: ones), 1 (one (B, H) mask), 3 ((3, B, H), one
// mask per gate r, z, n).
extern "C" int vqacx_gru_fwd(const void* xp, const void* w, const void* b,
                             const void* mask, int mask_gates, void* states,
                             void* hproj, int T, int B, int H, void* stream) {
  using vqacx::bf16;
  const bf16* xp_ = static_cast<const bf16*>(xp);
  const bf16* w_ = static_cast<const bf16*>(w);
  const float* b_ = static_cast<const float*>(b);
  const bf16* mask_ = mask_gates > 0 ? static_cast<const bf16*>(mask)
                                     : nullptr;
  bf16* states_ = static_cast<bf16*>(states);
  bf16* hproj_ = static_cast<bf16*>(hproj);
  if (mask_gates != 0 && mask_gates != 1 && mask_gates != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = (H % 8 == 0) && vqacx::aligned16(w) &&
                   vqacx::aligned16(states) &&
                   (mask_ == nullptr || vqacx::aligned16(mask_));
  const dim3 grid((H + vqacx::BJ - 1) / vqacx::BJ,
                  (B + vqacx::BM - 1) / vqacx::BM);
  const size_t step_h = (size_t)B * H;
  const size_t step_x = (size_t)B * 3 * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = 0; t < T; ++t) {
    const bf16* hp = t > 0 ? states_ + (t - 1) * step_h : nullptr;
    bf16* hpo = hproj_ != nullptr ? hproj_ + t * step_x : nullptr;
    if (mask_gates == 3)
      vqacx::gru_step_kernel<3><<<grid, vqacx::NT, 0, s>>>(
          xp_ + t * step_x, w_, b_, mask_, hp, states_ + t * step_h, hpo, B,
          H, vec);
    else
      vqacx::gru_step_kernel<1><<<grid, vqacx::NT, 0, s>>>(
          xp_ + t * step_x, w_, b_, mask_, hp, states_ + t * step_h, hpo, B,
          H, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The reverse sweep over the forward's residuals: dxp and dh_proj
// (T, B, 3H) bf16 from the state cotangents dstates (T, B, H) bf16.  dh is
// an f32 (B, H) scratch the caller zeroes.  mask_gates as for the forward.
extern "C" int vqacx_gru_bwd(const void* xp, const void* w, const void* mask,
                             int mask_gates, const void* states,
                             const void* hproj, const void* dstates,
                             void* dxp, void* dhproj, void* dh, int T, int B,
                             int H, void* stream) {
  using vqacx::bf16;
  if (mask_gates != 0 && mask_gates != 1 && mask_gates != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const bf16* xp_ = static_cast<const bf16*>(xp);
  const bf16* w_ = static_cast<const bf16*>(w);
  const bf16* mask_ = mask_gates > 0 ? static_cast<const bf16*>(mask)
                                     : nullptr;
  const bf16* states_ = static_cast<const bf16*>(states);
  const bf16* hproj_ = static_cast<const bf16*>(hproj);
  const bf16* ds_ = static_cast<const bf16*>(dstates);
  bf16* dxp_ = static_cast<bf16*>(dxp);
  bf16* dhp_ = static_cast<bf16*>(dhproj);
  float* dh_ = static_cast<float*>(dh);
  const size_t step_h = (size_t)B * H;
  const size_t step_x = (size_t)B * 3 * H;
  const size_t gstride = mask_gates == 3 ? step_h : 0;
  const bool vec = (H % 8 == 0) && vqacx::aligned16(w) &&
                   vqacx::aligned16(dhproj);
  int gate_blocks = static_cast<int>((step_h + vqacx::NT - 1) / vqacx::NT);
  if (gate_blocks > 65535) gate_blocks = 65535;
  const dim3 grid((H + vqacx::KBN - 1) / vqacx::KBN,
                  (B + vqacx::KBM - 1) / vqacx::KBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = T - 1; t >= 0; --t) {
    vqacx::gru_bwd_gate_kernel<<<gate_blocks, vqacx::NT, 0, s>>>(
        ds_ + t * step_h, xp_ + t * step_x, hproj_ + t * step_x,
        t > 0 ? states_ + (t - 1) * step_h : nullptr, dh_, dxp_ + t * step_x,
        dhp_ + t * step_x, B, H);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // the carry into h_{-1} is never used: no back term at t == 0
    if (t > 0) {
      vqacx::gru_bwd_back_kernel<<<grid, vqacx::NT, 0, s>>>(
          dhp_ + t * step_x, w_, mask_, gstride, dh_, B, H, vec);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
