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
// Backward: one launch per timestep, T in all.  The launch for step s
// first finishes the carry of step s + 1, dh += sum_g bf16(dh_proj_g) @
// W_g * mask_g (skipped for s = T - 1), then, in the same block's epilogue,
// recomputes r, z, n of step s from the bf16 residuals, emits its gate
// cotangents and leaves g * z in dh.  A block owns 64 batch rows x 32
// hidden units and all three gates' accumulators: one K loop over depth 3H
// (the three gates' tiles share each stage of a 3-stage cp.async ring),
// bf16 mma.sync with ldmatrix (.trans for W, which is MN-major here); 4
// warps of 16 rows x 32 units x 3 gates.  Step s's product needs whole
// dh_proj rows of step s + 1, a grid-wide dependency: hence a launch per
// step.
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

constexpr int KBM = 64;          // batch rows per block
constexpr int KBN = 32;          // hidden units per block
constexpr int KBK = 32;          // depth per stage, per gate
constexpr int KSTAGES = 3;
constexpr int KNT = 128;         // 4 warps of 16 rows x 32 units x 3 gates
constexpr int KLD = KBK + 8;     // bf16 stage row stride (= KBN + 8): the
                                 // 8 rows an ldmatrix phase reads hit
                                 // distinct 16-byte bank groups
static_assert(KBK == KBN, "A and W stage rows share the stride KLD");
constexpr int KA = 3 * KBM * KLD;                 // A: (gate, row, depth)
constexpr int KSTAGE = KA + 3 * KBK * KLD;        // + W: (gate, depth, unit)
constexpr int KLDC = KBN + 4;
constexpr int KRING = KSTAGES * KSTAGE * 2;
constexpr int KCS = 3 * KBM * KLDC * 4;
constexpr int KSMEM = KRING > KCS ? KRING : KCS;

// One stage: the three gates' A tiles, dh_proj[b0 + r, g*H + j0 + d], and
// W tiles, W[g*H + j0 + d, k0 + c]; zeros past B and H.
template <bool VEC>
__device__ __forceinline__ void bwd_load_stage(bf16* st,
                                               const bf16* __restrict__ dhp,
                                               const bf16* __restrict__ w,
                                               int b0, int k0, int j0, int B,
                                               int H) {
  const size_t h3 = (size_t)3 * H;
  bf16* As = st;
  bf16* Ws = st + KA;
  if constexpr (VEC) {   // H % 8 == 0: an 8-wide chunk is wholly in or out
    constexpr int CH = KBK / 8;
#pragma unroll
    for (int i = threadIdx.x; i < 3 * KBM * CH; i += KNT) {
      const int g = i / (KBM * CH), r = (i / CH) % KBM, d = (i % CH) * 8;
      const bool ok = b0 + r < B && j0 + d < H;
      cp_async16(As + (g * KBM + r) * KLD + d,
                 ok ? dhp + (b0 + r) * h3 + (size_t)g * H + j0 + d : dhp,
                 ok ? 16 : 0);
    }
    constexpr int CW = KBN / 8;
#pragma unroll
    for (int i = threadIdx.x; i < 3 * KBK * CW; i += KNT) {
      const int g = i / (KBK * CW), d = (i / CW) % KBK, c = (i % CW) * 8;
      const bool ok = j0 + d < H && k0 + c < H;
      cp_async16(Ws + (g * KBK + d) * KLD + c,
                 ok ? w + ((size_t)g * H + j0 + d) * H + k0 + c : w,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < 3 * KBM * KBK; i += KNT) {
      const int g = i / (KBM * KBK), r = (i / KBK) % KBM, d = i % KBK;
      As[(g * KBM + r) * KLD + d] =
          (b0 + r < B && j0 + d < H)
              ? dhp[(b0 + r) * h3 + (size_t)g * H + j0 + d]
              : bf16_zero();
    }
    for (int i = threadIdx.x; i < 3 * KBK * KBN; i += KNT) {
      const int g = i / (KBK * KBN), d = (i / KBN) % KBK, c = i % KBN;
      Ws[(g * KBK + d) * KLD + c] =
          (j0 + d < H && k0 + c < H)
              ? w[((size_t)g * H + j0 + d) * H + k0 + c]
              : bf16_zero();
    }
  }
}

// Reverse timestep s.  dhp_next == nullptr means s == T - 1 (no carry in);
// h_prev == nullptr means s == 0.  mask == nullptr means ones; gstride is
// 0 for one shared (B, H) mask.  Per (b, k), in JAX's order:
//   dh += acc_r * mask_r;  dh += acc_z * mask_z;  dh += acc_n * mask_n
//   g = ds + dh;  dxp = bf16([dsr, dsz, dsn]);  dh_proj = bf16([dsr, dsz,
//   dhn]);  dh <- g * z
template <bool VEC>
__global__ void __launch_bounds__(KNT)
gru_bwd_step_kernel(const bf16* __restrict__ dhp_next,  // (B, 3H) or null
                    const bf16* __restrict__ w,         // (3H, H)
                    const bf16* __restrict__ mask,      // (B, H) / (3, B, H)
                    size_t gstride,
                    float* __restrict__ dh,             // (B, H) in / out
                    const bf16* __restrict__ ds_s,      // (B, H)
                    const bf16* __restrict__ xp_s,      // (B, 3H)
                    const bf16* __restrict__ hp_s,      // (B, 3H)
                    const bf16* __restrict__ h_prev,    // (B, H) or null
                    bf16* __restrict__ dxp_s,           // (B, 3H)
                    bf16* __restrict__ dhp_s,           // (B, 3H)
                    int B, int H) {
  extern __shared__ __align__(128) unsigned char kdyn[];
  bf16* ring = reinterpret_cast<bf16*>(kdyn);
  float* Cs = reinterpret_cast<float*>(kdyn);  // (3, KBM, KLDC) afterwards
  const int k0 = blockIdx.x * KBN;
  const int b0 = blockIdx.y * KBM;
  const bool carry = dhp_next != nullptr;

  if (carry) {
    // the epilogue's operands, cold in device memory, start toward L2 now
    // and arrive while the product runs: per row, 64-byte runs of ds,
    // h_prev, the masks, the three gates of xp and h_proj, and dh
    for (int i = threadIdx.x; i < KBM * 12; i += KNT) {
      const int r = i / 12, a = i % 12, b = b0 + r;
      if (b >= B) continue;
      const size_t o = (size_t)b * H + k0;
      const size_t x0 = (size_t)b * 3 * H + k0;
      const void* p = nullptr;
      if (a == 0) p = ds_s + o;
      else if (a == 1) p = h_prev != nullptr ? h_prev + o : nullptr;
      else if (a < 5) p = mask != nullptr ? mask + (a - 2) * gstride + o
                                          : nullptr;
      else if (a < 8) p = xp_s + x0 + (size_t)(a - 5) * H;
      else if (a < 11) p = hp_s + x0 + (size_t)(a - 8) * H;
      else p = dh + o;
      if (p != nullptr) prefetch_l2(p);
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float acc[3][4][4];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][j][e] = 0.0f;
    const int nk = (H + KBK - 1) / KBK;
#pragma unroll
    for (int p = 0; p < KSTAGES - 1; ++p) {
      if (p < nk)
        bwd_load_stage<VEC>(ring + p * KSTAGE, dhp_next, w, b0, k0, p * KBK,
                            B, H);
      cp_async_commit();
    }
    // ldmatrix row addresses: A rows of this warp, W depth rows / units
    const int a_row = warp * 16 + lane % 16, a_col = (lane / 16) * 8;
    const int w_row = lane % 8 + ((lane / 8) % 2) * 8;
    const int w_col = (lane / 16) * 8;
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<KSTAGES - 2>();
      __syncthreads();
      const int nx = kc + KSTAGES - 1;
      if (nx < nk)
        bwd_load_stage<VEC>(ring + (nx % KSTAGES) * KSTAGE, dhp_next, w, b0,
                            k0, nx * KBK, B, H);
      cp_async_commit();
      const bf16* As = ring + (kc % KSTAGES) * KSTAGE;
      const bf16* Ws = As + KA;
#pragma unroll
      for (int ks = 0; ks < KBK; ks += 16) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          unsigned a[4];
          ldmatrix_x4(a, As + (g * KBM + a_row) * KLD + ks + a_col);
#pragma unroll
          for (int p = 0; p < 2; ++p) {   // units 16 p .. 16 p + 15
            unsigned b[4];
            ldmatrix_x4_trans(b, Ws + (g * KBK + ks + w_row) * KLD + p * 16
                                     + w_col);
            mma_bf16_16816(acc[g][2 * p], a, b[0], b[1]);
            mma_bf16_16816(acc[g][2 * p + 1], a, b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free: stage the sums for the epilogue
    const int g_id = lane / 4, t = lane % 4;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          Cs[(g * KBM + warp * 16 + g_id + (e / 2) * 8) * KLDC + j * 8
             + 2 * t + e % 2] = acc[g][j][e];
    __syncthreads();
  }

  // elementwise over the block's (row, unit) tile, a warp along one row;
  // each thread loads EU elements' operands before it computes any
  constexpr int EU = 4;
  const size_t h3 = (size_t)3 * H;
  for (int i0 = threadIdx.x; i0 < KBM * KBN; i0 += EU * KNT) {
    bool ok[EU];
    float d[EU], dsv[EU], xr[EU], xz[EU], xn[EU], hr[EU], hz[EU], hn[EU],
        hprev[EU];
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      const int i = i0 + u * KNT;
      const int r = i / KBN, c = i % KBN;
      const int b = b0 + r, k = k0 + c;
      ok[u] = i < KBM * KBN && b < B && k < H;
      if (!ok[u]) continue;
      const size_t o = (size_t)b * H + k;
      const size_t x0 = (size_t)b * h3 + k;
      d[u] = 0.0f;
      if (carry) {
        d[u] = dh[o];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float m = mask != nullptr ? f32(mask[g * gstride + o]) : 1.0f;
          d[u] = __fmaf_rn(Cs[(g * KBM + r) * KLDC + c], m, d[u]);
        }
      }
      dsv[u] = f32(ds_s[o]);
      xr[u] = f32(xp_s[x0]);
      xz[u] = f32(xp_s[x0 + H]);
      xn[u] = f32(xp_s[x0 + 2 * H]);
      hr[u] = f32(hp_s[x0]);
      hz[u] = f32(hp_s[x0 + H]);
      hn[u] = f32(hp_s[x0 + 2 * H]);
      hprev[u] = h_prev != nullptr ? f32(h_prev[o]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < EU; ++u) {
      if (!ok[u]) continue;
      const int i = i0 + u * KNT;
      const int b = b0 + i / KBN, k = k0 + i % KBN;
      const size_t o = (size_t)b * H + k;
      const size_t x0 = (size_t)b * h3 + k;
      const float gg = dsv[u] + d[u];
      const float rg = sigmoid(xr[u] + hr[u]);
      const float z = sigmoid(xz[u] + hz[u]);
      const float nn = tanhf(xn[u] + rg * hn[u]);
      const float dn = gg * (1.0f - z);
      const float dsz = gg * (hprev[u] - nn) * z * (1.0f - z);
      const float dsn = dn * (1.0f - nn * nn);
      const float dhn = dsn * rg;
      const float dsr = dsn * hn[u] * rg * (1.0f - rg);
      dxp_s[x0] = rn(dsr);
      dxp_s[x0 + H] = rn(dsz);
      dxp_s[x0 + 2 * H] = rn(dsn);
      dhp_s[x0] = rn(dsr);
      dhp_s[x0 + H] = rn(dsz);
      dhp_s[x0 + 2 * H] = rn(dhn);
      dh[o] = gg * z;
    }
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
// (T, B, 3H) bf16 from the state cotangents dstates (T, B, H) bf16, in T
// launches.  dh is an f32 (B, H) scratch (not read before it is written).
// mask_gates as for the forward.
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
  auto kernel = vec ? vqacx::gru_bwd_step_kernel<true>
                    : vqacx::gru_bwd_step_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, vqacx::KSMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H + vqacx::KBN - 1) / vqacx::KBN,
                  (B + vqacx::KBM - 1) / vqacx::KBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int t = T - 1; t >= 0; --t) {
    kernel<<<grid, vqacx::KNT, vqacx::KSMEM, s>>>(
        t < T - 1 ? dhp_ + (t + 1) * step_x : nullptr, w_, mask_, gstride,
        dh_, ds_ + t * step_h, xp_ + t * step_x, hproj_ + t * step_x,
        t > 0 ? states_ + (t - 1) * step_h : nullptr, dxp_ + t * step_x,
        dhp_ + t * step_x, B, H);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
