// Candidate image features with the gather inside the kernel (see
// ops/cuda/vfeat_kernel.py).
//
// GEMM rows are the B*K (example, candidate) pairs, row m = b*K + k, whose
// operand rows are gathered from the feature table by index.  Block tile:
// 64 rows x 64 output columns, two GEMMs (x and bf16(o*x)) sharing the row
// tiles.  8 warps: 4 along the rows (16 each) x 2 along the columns (32 =
// 2 fragments each).  Blocks with blockIdx.y == 0 also accumulate the f32
// squared distance of their rows.  The backward (the two weight gradients)
// is further down.
#include <algorithm>

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

// ---- backward: the two weight gradients ----
//
// dWo[h, d] = sum_r g[r, h] * x_r[d],  dWm[h, d] = sum_r g[r, h] * m_r[d]
// over the B*K rows r = b*K + k, with x_r = table[idx[b, k+1]] and
// m_r = bf16(table[idx[b, 0]] * x_r) (the forward's rounding).  A block
// owns one (GBM h x GBN d) tile of both outputs and walks its share of the
// rows in GBK-row chunks: the g^T tile is staged [row][h] and read as a
// col-major A fragment, the gathered x rows and the m rows formed from
// them are staged [row][d] and read as row-major B fragments.  8 warps:
// 4 along h (16 each) x 2 along d (64 = 4 fragments each).  With
// ``splits`` > 1 the rows are cut into that many contiguous ranges (grid z)
// whose f32 partial tiles are summed in split order by vfeat_bwd_reduce:
// the result does not depend on scheduling.
constexpr int GBM = 64;
constexpr int GBN = 128;
constexpr int GBK = 32;
constexpr int LDG = GBM + 8;
constexpr int LDX = GBN + 8;
constexpr int LDCB = GBN + 4;
constexpr int SMEM_B_OPS = (GBK * LDG + 2 * GBK * LDX) * 2;
constexpr int SMEM_B_C = GBM * LDCB * 4;  // one f32 output tile at a time
constexpr int SMEM_B = SMEM_B_OPS > SMEM_B_C ? SMEM_B_OPS : SMEM_B_C;
constexpr int XCH = GBN / 8;
constexpr int X_PASSES = GBK * XCH / NT;
static_assert(GBK * XCH % NT == 0, "x-tile chunks must divide over threads");

__global__ void __launch_bounds__(NT)
vfeat_bwd_kernel(const bf16* __restrict__ table, int N, int Dv,
                 const int* __restrict__ idx,        // (B, K+1)
                 int B, int K,
                 const bf16* __restrict__ g,         // (B*K, H)
                 int H, int rows_per_split,
                 float* __restrict__ dwo,            // (H, Dv) per split
                 float* __restrict__ dwm,
                 size_t split_stride, bool vec_x, bool vec_g) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[SMEM_B];
  bf16* Gs = reinterpret_cast<bf16*>(smem);
  bf16* Xs = Gs + GBK * LDG;
  bf16* Ms = Xs + GBK * LDX;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the row loop

  const int M = B * K;
  const int d0 = blockIdx.x * GBN;
  const int h0 = blockIdx.y * GBM;
  const int rbeg = blockIdx.z * rows_per_split;
  const int rend = min(M, rbeg + rows_per_split);
  const int warp = threadIdx.x / 32;
  const int wmi = warp % 4;
  const int wni = warp / 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_o[4], acc_m[4];
  for (int f = 0; f < 4; ++f) {
    wmma::fill_fragment(acc_o[f], 0.0f);
    wmma::fill_fragment(acc_m[f], 0.0f);
  }

  for (int r0 = rbeg; r0 < rend; r0 += GBK) {
    load_tile<GBK, GBM, LDG, NT>(Gs, g, H, r0, rend, h0, H, vec_g);
    for (int p = 0; p < X_PASSES; ++p) {
      const int c = threadIdx.x + p * NT;
      const int r = c / XCH;
      const int dc = (c % XCH) * 8;
      const int gd = d0 + dc;
      const int m = r0 + r;
      bf16* dx = Xs + r * LDX + dc;
      bf16* dm = Ms + r * LDX + dc;
      if (m < rend) {
        const int b = m / K;
        const int k = m % K;
        const int xr = min(max(idx[(size_t)b * (K + 1) + 1 + k], 0), N - 1);
        const int orr = min(max(idx[(size_t)b * (K + 1)], 0), N - 1);
        if (vec_x && gd + 8 <= Dv) {
          Pack8 xv, ov, mv;
          xv.u = *reinterpret_cast<const uint4*>(table + (size_t)xr * Dv + gd);
          ov.u = *reinterpret_cast<const uint4*>(table + (size_t)orr * Dv + gd);
          for (int e = 0; e < 8; ++e)
            set_lane8(mv, e, rn(f32(lane8(ov, e)) * f32(lane8(xv, e))));
          *reinterpret_cast<uint4*>(dx) = xv.u;
          *reinterpret_cast<uint4*>(dm) = mv.u;
        } else {
          for (int e = 0; e < 8; ++e) {
            bf16 xb = bf16_zero();
            bf16 mb = bf16_zero();
            if (gd + e < Dv) {
              xb = table[(size_t)xr * Dv + gd + e];
              mb = rn(f32(table[(size_t)orr * Dv + gd + e]) * f32(xb));
            }
            dx[e] = xb;
            dm[e] = mb;
          }
        }
      } else {
        for (int e = 0; e < 8; ++e) {
          dx[e] = bf16_zero();
          dm[e] = bf16_zero();
        }
      }
    }
    __syncthreads();
    for (int kk = 0; kk < GBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
      wmma::load_matrix_sync(fa, Gs + kk * LDG + wmi * 16, LDG);
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, Xs + kk * LDX + wni * 64 + f * 16, LDX);
        wmma::mma_sync(acc_o[f], fa, fb, acc_o[f]);
        wmma::load_matrix_sync(fb, Ms + kk * LDX + wni * 64 + f * 16, LDX);
        wmma::mma_sync(acc_m[f], fa, fb, acc_m[f]);
      }
    }
    __syncthreads();
  }

  // one output tile at a time through shared memory (masked edges)
  auto write_tile = [&](wmma::fragment<wmma::accumulator, 16, 16, 16,
                                       float> (&acc)[4], float* out) {
    for (int f = 0; f < 4; ++f)
      wmma::store_matrix_sync(Cs + (wmi * 16) * LDCB + wni * 64 + f * 16,
                              acc[f], LDCB, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < GBM * GBN; i += NT) {
      const int r = i / GBN;
      const int n = i % GBN;
      if (h0 + r < H && d0 + n < Dv)
        out[(size_t)(h0 + r) * Dv + d0 + n] = Cs[r * LDCB + n];
    }
    __syncthreads();
  };
  write_tile(acc_o, dwo + blockIdx.z * split_stride);
  write_tile(acc_m, dwm + blockIdx.z * split_stride);
}

// Sum the split partials (split-major [split][2][H*Dv]) in split order.
__global__ void vfeat_bwd_reduce(const float* __restrict__ part, int splits,
                                 size_t n, float* __restrict__ dwo,
                                 float* __restrict__ dwm) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * 2 * n + i];
    if (i < n)
      dwo[i] = s;
    else
      dwm[i - n] = s;
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

// ``part``: f32 scratch of splits * 2 * H * Dv when splits > 1 (unused
// otherwise); dwo / dwm: f32 (H, Dv) outputs.
extern "C" int vqacx_vfeat_bwd(const void* table, int N, int Dv,
                               const void* idx, int B, int K, const void* g,
                               int H, int splits, void* part, void* dwo,
                               void* dwm, void* stream) {
  using vqacx::bf16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_x = (Dv % 8 == 0) && vqacx::aligned16(table);
  const bool vec_g = (H % 8 == 0) && vqacx::aligned16(g);
  const int M = B * K;
  const int chunks = (M + vqacx::GBK - 1) / vqacx::GBK;
  const int rows_per_split = ((chunks + splits - 1) / splits) * vqacx::GBK;
  const size_t n = (size_t)H * Dv;
  float* out_o = static_cast<float*>(splits > 1 ? part : dwo);
  float* out_m = splits > 1 ? static_cast<float*>(part) + n
                            : static_cast<float*>(dwm);
  const dim3 grid((Dv + vqacx::GBN - 1) / vqacx::GBN,
                  (H + vqacx::GBM - 1) / vqacx::GBM, splits);
  vqacx::vfeat_bwd_kernel<<<grid, vqacx::NT, 0, st>>>(
      static_cast<const bf16*>(table), N, Dv, static_cast<const int*>(idx), B,
      K, static_cast<const bf16*>(g), H, rows_per_split, out_o, out_m,
      splits > 1 ? 2 * n : 0, vec_x, vec_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int threads = 256;
  const int blocks = (int)std::min<size_t>((2 * n + threads - 1) / threads,
                                           4096);
  vqacx::vfeat_bwd_reduce<<<blocks, threads, 0, st>>>(
      static_cast<const float*>(part), splits, n, static_cast<float*>(dwo),
      static_cast<float*>(dwm));
  return static_cast<int>(cudaGetLastError());
}
