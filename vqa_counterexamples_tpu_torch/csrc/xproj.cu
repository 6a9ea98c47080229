// The GRU's input projection on the bf16 tensor cores: the forward, dX and
// dW with db, and the pass that packs their bf16 operands (see
// ops/cuda/xproj_kernel.py for the functions and their rounding points).
//
// Rows are time-major, r = t B + b; x is (B, T, D) f32, W (3H, D) f32,
// dG the (T, B, 3H) bf16 cotangent.  Every product is a tiled GEMM of
// 128 x 128 output tiles, 64 deep a chunk, on two warpgroups (wgmma
// m64n128k16, f32 accumulators) that also issue the chunk copies
// (cp.async, ``load_box``) into a ring of S stages of 128B-swizzled tiles,
// DIST = S - 1 - INF chunks ahead, INF wgmma groups left in flight while
// the next chunk lands.  The forward runs S 3, INF 0, two CTAs an SM (99
// KB each): its 10 chunks (D 620) leave a CTA's fill and epilogue exposed,
// and the second CTA hides them (0.44 against 0.54 ms with S 4, INF 1 at
// B 512 on an H100).  dX and dW run S 4, INF 1, one CTA an SM (131 KB, dX
// 199 KB with its mask tile): dX holds two f32 tiles a thread (200-odd
// registers), and dW ran within 5% either way.  Neither order changed at
// any of the GRU paths' row counts (26 to 53,248) or mask kinds.
//
// - xproj_pack_kernel (elementwise): bf16(W) and bf16(x * m_g) of each
//   mask gate, time-major, both in rows of KP (D rounded up to 8: 16-byte
//   rows, which TMA's and cp.async's strides need; D 620's 1,240-byte
//   bf16 rows are not) with zeros past D.  One launch for both.
// - xproj_gemm_fwd_kernel: out[r, g H + j] = bf16(acc + b); A the packed
//   x * m_g (K-major), B the packed W_g (K-major).  With per-gate masks a
//   CTA's columns stay inside one gate.  The CTAs of a row tile are
//   neighbours, so its A tiles are read from L2 by all but the first.
// - xproj_gemm_dx_kernel: dx[b, t] = sum over the gates n, z, r (autograd's
//   order through the composition) of m_g * bf16(dG_g W_g): A dG
//   (K-major), B the packed W read MN-major (the d index contiguous); each
//   gate's sum is rounded and folded into an f32 total in registers, then
//   written once into x's (B, T, D) layout.  The gate's mask tile (f32,
//   128 x 128) is copied into shared memory while the gate's products
//   run: gathered at the fold, at 240-odd registers a thread, it cost a
//   third of the kernel.
// - xproj_gemm_dw_kernel: dW_g = bf16(dG_g^T x m_g), K the rows: A dG
//   read MN-major (3H contiguous), B the packed x * m_g read MN-major;
//   the CTAs of the first D tile also sum dG's columns (db) from the
//   stages they already hold, in a fixed order.
//
// Every sum runs in one fixed order: reruns are bit-equal, no atomics.
#include <algorithm>

#include "common.cuh"

namespace vqacx {
namespace {

constexpr int BM = 128;          // output rows a CTA: a warpgroup's 64 each
constexpr int BN = 128;          // output columns a CTA: one wgmma N
constexpr int BK = 64;           // depth a chunk: 128-byte rows
constexpr int NT = 256;          // the two warpgroups
constexpr int HALF = 64 * 128;   // 8 KB: 64 rows x 64 deep or 64 deep x 64
constexpr int TILE = 2 * HALF;   // an operand's tile of a chunk
constexpr int STAGE = 2 * TILE;  // A, then B
constexpr int RED = 2 * BM * 4;  // dW's db partials
constexpr int MP = BN + 8;       // dX's mask tile: its row pitch (f32)
constexpr int MTILE = BM * MP * 4;

__host__ __device__ constexpr int xp_smem(int stages) {
  return 1024 + stages * STAGE + RED;
}

__host__ __device__ constexpr int dx_smem(int stages) {
  return xp_smem(stages) + MTILE;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The chunks 0 .. nseg * seg - 1 of a CTA, ``seg`` chunks a sum.  load(c,
// st) issues chunk c's copies into stage st (A at st, B at st + TILE); A's
// warpgroup halves are HALF apart, K-major (TA 0) or MN-major (1, 64
// wide); B is 128 K-major rows (TB 0) or two MN-major blocks of 64 (1).
// peek(st) reads a landed stage; done(s) runs after sum s's products are
// waited for.  Nothing touches the accumulators between a chunk's
// products and the wait of the next (a branch there would make ptxas
// wait for every group).
template <int S, int INF, int TA, int TB, typename Load, typename Peek,
          typename Done>
__device__ __forceinline__ void run(float (&acc)[BN / 2], unsigned char* ring,
                                    int nseg, int seg, Load load, Peek peek,
                                    Done done) {
  constexpr int DIST = S - 1 - INF;
  static_assert(DIST >= 1 && INF >= 0, "a ring of at least INF + 2 stages");
  const int wg = threadIdx.x / 128;
  const int nc = nseg * seg;
  for (int c = 0; c < DIST; ++c) {
    if (c < nc) load(c, ring + c * STAGE);
    cp_async_commit();
  }
  for (int sg = 0; sg < nseg; ++sg) {
    for (int kc = 0; kc < seg; ++kc) {
      const int c = sg * seg + kc;
      cp_async_wait<DIST - 1>();   // this thread's copies of chunk c
      fence_proxy_async();         // they (or its plain stores) to wgmma
      // everyone's copies have landed; everyone's products of chunk
      // c - 1 - INF are done, so its stage takes chunk c + DIST
      __syncthreads();
      if (c + DIST < nc) load(c + DIST, ring + ((c + DIST) % S) * STAGE);
      cp_async_commit();
      unsigned char* st = ring + (c % S) * STAGE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint64_t a, b;
        if constexpr (TA)
          a = gmma_desc_mn(st + wg * HALF) + 128 * kk;
        else
          a = gmma_desc<128>(st + wg * HALF) + 2 * kk;
        if constexpr (TB)
          b = gmma_desc_mn(st + TILE, HALF) + 128 * kk;
        else
          b = gmma_desc<128>(st + TILE) + 2 * kk;
        wgmma_bf16_ss<BN, TA, TB>(acc, a, b, kc > 0 || kk > 0);
      }
      wgmma_commit();
      peek(st);
      wgmma_wait<INF>();
      fence_acc(acc);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    done(sg);
  }
}

// Thread t of a warpgroup holds, in n8 block i, rows ROW(t) and + 8 and
// columns 8 i + COL(t) and + 1, at acc[4 i + 2 h + c] (h the row half, c
// the column).
__device__ __forceinline__ int frag_row() {
  const int t = threadIdx.x % 128;
  return (threadIdx.x / 128) * 64 + (t / 32) * 16 + (t % 32) / 4;
}

__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x % 4); }

// ------------------------------------------------------------------ pack

__global__ void xproj_pack_kernel(const float* __restrict__ w, bf16* wp,
                                  int h3, const float* __restrict__ x,
                                  const float* __restrict__ mask, bf16* xm,
                                  int B, int T, int D, int KP, int gates,
                                  int mask_gates) {
  const int per_row = KP / 8;
  const size_t M = (size_t)B * T;
  const size_t uw = (size_t)h3 * per_row;
  const size_t total = uw + (size_t)gates * M * per_row;
  for (size_t u = (size_t)blockIdx.x * blockDim.x + threadIdx.x; u < total;
       u += (size_t)gridDim.x * blockDim.x) {
    Pack8 v;
    if (u < uw) {
      const size_t row = u / per_row;
      const int k0 = (int)(u % per_row) * 8;
      const float* src = w + row * D;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        set_lane8(v, e, k0 + e < D ? rn(src[k0 + e]) : bf16_zero());
      *reinterpret_cast<uint4*>(wp + row * KP + k0) = v.u;
    } else {
      const size_t i = u - uw;
      const size_t g = i / (M * per_row);
      const size_t r = (i / per_row) % M;
      const int k0 = (int)(i % per_row) * 8;
      const size_t t = r / B, b = r % B;
      const float* xs = x + (b * T + t) * D;
      const float* ms =
          mask_gates == 0
              ? nullptr
              : mask + ((mask_gates == 3 ? g * B : 0) + b) * D;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + e;
        set_lane8(v, e,
                  k < D ? rn(ms != nullptr ? xs[k] * ms[k] : xs[k])
                        : bf16_zero());
      }
      *reinterpret_cast<uint4*>(xm + (g * M + r) * KP + k0) = v.u;
    }
  }
}

// --------------------------------------------------------------- forward

struct FwdP {
  const bf16* xm;      // (gates, M, KP)
  const bf16* w;       // (H3, KP)
  const float* bias;   // (H3,)
  bf16* out;           // (M, H3)
  int M, KP, H3, gates;
  int ct;              // column tiles a gate
};

template <int S, int INF>
__global__ void __launch_bounds__(NT, INF == 0 ? 2 : 1)
xproj_gemm_fwd_kernel(const FwdP p) {
  extern __shared__ unsigned char xp_dyn[];
  unsigned char* ring = align1024(xp_dyn);
  const int GW = p.H3 / p.gates;
  const int per_row = p.gates * p.ct;
  const int m0 = (blockIdx.x / per_row) * BM;
  const int gate = (blockIdx.x % per_row) / p.ct;
  const int j0 = (blockIdx.x % p.ct) * BN;
  const int g0 = gate * GW;
  const bf16* a = p.xm + (size_t)gate * p.M * p.KP;
  const int nc = (p.KP + BK - 1) / BK;
  float acc[BN / 2];
  run<S, INF, 0, 0>(
      acc, ring, 1, nc,
      [&](int c, unsigned char* st) {
        load_box<8, NT>(st, a, p.KP, m0, p.M, c * BK, p.KP, BM);
        load_box<8, NT>(st + TILE, p.w, p.KP, g0 + j0, g0 + GW, c * BK,
                        p.KP, BN);
      },
      [](const unsigned char*) {}, [](int) {});
  // out = bf16(acc + b): the f32 sum, then one rounding
  const int row = m0 + frag_row(), cq = frag_col();
  const bool pairs = p.H3 % 2 == 0 && GW % 2 == 0;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int j = j0 + 8 * i + cq;
    if (j >= GW) continue;
    const bool two = j + 1 < GW;
    const float b0 = p.bias[g0 + j], b1 = two ? p.bias[g0 + j + 1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r >= p.M) continue;
      bf16* o = p.out + (size_t)r * p.H3 + g0 + j;
      const float v0 = acc[4 * i + 2 * h] + b0;
      const float v1 = acc[4 * i + 2 * h + 1] + b1;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = rn(v0);
        if (two) o[1] = rn(v1);
      }
    }
  }
}

// -------------------------------------------------------------------- dX

struct DxP {
  const bf16* g;       // (M, H3)
  const bf16* w;       // (H3, KP)
  const float* mask;   // (3, B, D), (B, D) or null
  float* dx;           // (B, T, D)
  int B, T, D, KP, H3;
  int mask_gates;      // 3, 1 or 0
  bool mask_v4;        // mask rows copied 16 bytes at a time
};

template <int S, int INF, int VG>
__global__ void __launch_bounds__(NT, 1) xproj_gemm_dx_kernel(const DxP p) {
  extern __shared__ unsigned char xp_dyn[];
  unsigned char* ring = align1024(xp_dyn);
  float* mt = reinterpret_cast<float*>(ring + S * STAGE + RED);  // [BM][MP]
  const int M = p.B * p.T;
  const int nct = (p.D + BN - 1) / BN;
  const int m0 = (blockIdx.x / nct) * BM, n0 = (blockIdx.x % nct) * BN;
  const int gates = p.mask_gates == 3 ? 3 : 1;
  const int KW = p.H3 / gates;
  const int kcs = (KW + BK - 1) / BK;
  const int row = frag_row(), cq = frag_col();
  // gate gi's mask rows m[b] for the tile's rows, columns n0 .. n0 + 127,
  // zeros outside; the copies join the next commit group
  auto load_mask = [&](int gi) {
    const float* src = p.mask + (size_t)(p.mask_gates == 3 ? gi * p.B : 0) *
                                    p.D;
    if (p.mask_v4) {
      for (int i = threadIdx.x; i < BM * (BN / 4); i += NT) {
        const int rr = i / (BN / 4), cc = 4 * (i % (BN / 4));
        const int r = m0 + rr, d = n0 + cc;
        const bool ok = r < M && d < p.D;
        cp_async16(mt + rr * MP + cc,
                   ok ? src + (size_t)(r % p.B) * p.D + d : src,
                   ok ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < BM * BN; i += NT) {
        const int rr = i / BN, cc = i % BN;
        const int r = m0 + rr, d = n0 + cc;
        const bool ok = r < M && d < p.D;
        cp_async4(mt + rr * MP + cc,
                  ok ? src + (size_t)(r % p.B) * p.D + d : src, ok ? 4 : 0);
      }
    }
  };
  if (p.mask_gates != 0) load_mask(gates - 1);
  float acc[BN / 2], total[BN / 2];
  run<S, INF, 0, 1>(
      acc, ring, gates, kcs,
      [&](int c, unsigned char* st) {
        const int gi = gates - 1 - c / kcs;
        const int k0 = gi * KW + (c % kcs) * BK, kend = (gi + 1) * KW;
        load_box<VG, NT>(st, p.g, p.H3, m0, M, k0, kend, BM);
        load_box<8, NT>(st + TILE, p.w, p.KP, k0, kend, n0, p.KP, 64);
        load_box<8, NT>(st + TILE + HALF, p.w, p.KP, k0, kend, n0 + 64, p.KP,
                        64);
      },
      [](const unsigned char*) {},
      [&](int s) {
        // total (+)= m_g * f32(bf16(acc)): the product and the sum each
        // rounded once, as the composition's separate operations are
        if (p.mask_gates != 0) {
          cp_async_wait<0>();   // this thread's copies of the mask tile
          __syncthreads();      // everyone's
        }
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int q = 4 * i + 2 * h + c;
              float v = f32(rn(acc[q]));
              if (p.mask_gates != 0)
                v = __fmul_rn(v, mt[(row + 8 * h) * MP + 8 * i + cq + c]);
              total[q] = s == 0 ? v : __fadd_rn(total[q], v);
            }
        if (p.mask_gates == 3 && s + 1 < gates) {
          __syncthreads();      // everyone has read the tile
          load_mask(gates - 2 - s);
        }
      });
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + row + 8 * h;
    if (r >= M) continue;
    float* o = p.dx + ((size_t)(r % p.B) * p.T + r / p.B) * p.D;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int d = n0 + 8 * i + cq + c;
        if (d < p.D) o[d] = total[4 * i + 2 * h + c];
      }
  }
}

// -------------------------------------------------------------- dW and db

struct DwP {
  const bf16* g;       // (M, H3)
  const bf16* xm;      // (gates, M, KP)
  float* dw;           // (H3, D)
  float* db;           // (H3,) or null
  int M, D, KP, H3, gates;
  int ct;              // column tiles (of 3H) a gate
};

template <int S, int INF, int VG>
__global__ void __launch_bounds__(NT, INF == 0 ? 2 : 1)
xproj_gemm_dw_kernel(const DwP p) {
  extern __shared__ unsigned char xp_dyn[];
  unsigned char* ring = align1024(xp_dyn);
  float* red = reinterpret_cast<float*>(ring + S * STAGE);   // [2][BM]
  const int GW = p.H3 / p.gates;
  const int nd = (p.D + BN - 1) / BN;
  const int jt = blockIdx.x / nd, d0 = (blockIdx.x % nd) * BN;
  const int gate = jt / p.ct;
  const int n0 = gate * GW + (jt % p.ct) * BN, gend = (gate + 1) * GW;
  const bf16* xg = p.xm + (size_t)gate * p.M * p.KP;
  const bool sums = p.db != nullptr && d0 == 0;
  // db: thread (warpgroup w, t) sums column t % 64 of w's A half over the
  // chunk rows 32 (t / 64) .. + 31
  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int scol = tw % 64, shalf = tw / 64;
  float s = 0.0f;
  float acc[BN / 2];
  run<S, INF, 1, 1>(
      acc, ring, 1, (p.M + BK - 1) / BK,
      [&](int c, unsigned char* st) {
        const int k0 = c * BK;
        load_box<VG, NT>(st, p.g, p.H3, k0, p.M, n0, gend, 64);
        load_box<VG, NT>(st + HALF, p.g, p.H3, k0, p.M, n0 + 64, gend, 64);
        load_box<8, NT>(st + TILE, xg, p.KP, k0, p.M, d0, p.KP, 64);
        load_box<8, NT>(st + TILE + HALF, xg, p.KP, k0, p.M, d0 + 64, p.KP,
                        64);
      },
      [&](const unsigned char* st) {
        if (!sums) return;
        const unsigned char* half = st + wg * HALF;
#pragma unroll 8
        for (int k = 32 * shalf; k < 32 * shalf + 32; ++k)
          s += f32(*reinterpret_cast<const bf16*>(
              half + swizzled<128>(k, scol)));
      },
      [](int) {});
  // dW = f32(bf16(acc))
  const int row = n0 + frag_row(), cq = frag_col();
  const bool pairs = p.D % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = row + 8 * h;
    if (n >= gend) continue;
    float* o = p.dw + (size_t)n * p.D;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int d = d0 + 8 * i + cq;
      const float v0 = f32(rn(acc[4 * i + 2 * h]));
      const float v1 = f32(rn(acc[4 * i + 2 * h + 1]));
      if (pairs && d + 1 < p.D) {
        *reinterpret_cast<float2*>(o + d) = make_float2(v0, v1);
      } else {
        if (d < p.D) o[d] = v0;
        if (d + 1 < p.D) o[d + 1] = v1;
      }
    }
  }
  if (sums) {
    red[shalf * BM + wg * 64 + scol] = s;
    __syncthreads();
    const int n = n0 + wg * 64 + scol;
    if (shalf == 0 && n < gend)
      p.db[n] = red[wg * 64 + scol] + red[BM + wg * 64 + scol];
  }
}

constexpr int FWD_S = 3, FWD_INF = 0;   // see the note at the top
constexpr int BWD_S = 4, BWD_INF = 1;

template <typename Kernel, typename P>
cudaError_t launch(Kernel kernel, int grid, int smem, cudaStream_t s,
                   const P& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, s>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// bf16(W) into wp (h3, KP) and bf16(x * m_g) into xm (gates, B T, KP),
// time-major; mask (3, B, D), (B, D) or null for
// mask_gates 3, 1 or 0; gates 3 (one operand a mask gate) or 1.
extern "C" int vqacx_xproj_pack(const void* w, void* wp, int h3,
                                const void* x, const void* mask, void* xm,
                                int B, int T, int D, int KP, int gates,
                                int mask_gates, void* stream) {
  using namespace vqacx;
  if (B <= 0 || T <= 0 || D <= 0 || KP < D || KP % 8 != 0 ||
      (gates != 1 && gates != 3) || (gates == 3 && mask_gates != 3) ||
      (mask_gates != 0 && mask == nullptr) || !aligned16(xm) ||
      !aligned16(wp))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t units = ((size_t)h3 + (size_t)gates * B * T) * (KP / 8);
  const int grid = (int)std::min<size_t>((units + 255) / 256, 132 * 32);
  xproj_pack_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<bf16*>(wp), h3,
      static_cast<const float*>(x), static_cast<const float*>(mask),
      static_cast<bf16*>(xm), B, T, D, KP, gates, mask_gates);
  return static_cast<int>(cudaGetLastError());
}

// out (M, H3) bf16 = bf16(xm_g @ wp_g^T + bias_g) over ``gates`` column
// groups (3: one per mask gate, xm's; 1: xm[0] for all 3H columns).
extern "C" int vqacx_xproj_fwd(const void* xm, const void* wp,
                               const void* bias, void* out, int M, int KP,
                               int H3, int gates, void* stream) {
  using namespace vqacx;
  if (M <= 0 || KP <= 0 || KP % 8 != 0 || H3 <= 0 || H3 % gates != 0 ||
      !aligned16(xm) || !aligned16(wp))
    return static_cast<int>(cudaErrorInvalidValue);
  const int GW = H3 / gates;
  const FwdP p{static_cast<const bf16*>(xm), static_cast<const bf16*>(wp),
               static_cast<const float*>(bias), static_cast<bf16*>(out),
               M, KP, H3, gates, (GW + BN - 1) / BN};
  const int grid = ((M + BM - 1) / BM) * gates * p.ct;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch(xproj_gemm_fwd_kernel<FWD_S, FWD_INF>,
                                 grid, xp_smem(FWD_S), s, p));
}

// dx (B, T, D) f32 from g (T B, H3) bf16 and wp (H3, KP) bf16 (see the
// note at the top); mask_gates 3, 1 or 0 as vqacx_xproj_pack's.
extern "C" int vqacx_xproj_dx(const void* g, const void* wp,
                              const void* mask, void* dx, int B, int T,
                              int D, int KP, int H3, int mask_gates,
                              void* stream) {
  using namespace vqacx;
  const int gates = mask_gates == 3 ? 3 : 1;
  if (B <= 0 || T <= 0 || D <= 0 || KP < D || KP % 8 != 0 || H3 <= 0 ||
      H3 % gates != 0 || (mask_gates != 0 && mask == nullptr) ||
      !aligned16(wp))
    return static_cast<int>(cudaErrorInvalidValue);
  const DxP p{static_cast<const bf16*>(g), static_cast<const bf16*>(wp),
              static_cast<const float*>(mask), static_cast<float*>(dx),
              B, T, D, KP, H3, mask_gates,
              D % 4 == 0 && aligned16(mask)};
  const int grid = ((B * T + BM - 1) / BM) * ((D + BN - 1) / BN);
  // 16-byte copies of g where its rows and each gate's columns allow them
  const bool v8 = H3 % 8 == 0 && (H3 / gates) % 8 == 0 && aligned16(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      v8 ? launch(xproj_gemm_dx_kernel<BWD_S, BWD_INF, 8>, grid,
                  dx_smem(BWD_S), s, p)
         : launch(xproj_gemm_dx_kernel<BWD_S, BWD_INF, 1>, grid,
                  dx_smem(BWD_S), s, p));
}

// dW (H3, D) f32 = bf16(g_j^T xm_j) over ``gates`` column groups, and
// where db is not null db (H3,) f32 = the column sums of g.
extern "C" int vqacx_xproj_dw(const void* g, const void* xm, void* dw,
                              void* db, int M, int D, int KP, int H3,
                              int gates, void* stream) {
  using namespace vqacx;
  if (M <= 0 || D <= 0 || KP < D || KP % 8 != 0 || H3 <= 0 ||
      H3 % gates != 0 || !aligned16(xm))
    return static_cast<int>(cudaErrorInvalidValue);
  const int GW = H3 / gates;
  const DwP p{static_cast<const bf16*>(g), static_cast<const bf16*>(xm),
              static_cast<float*>(dw), static_cast<float*>(db),
              M, D, KP, H3, gates, (GW + BN - 1) / BN};
  const int grid = gates * p.ct * ((D + BN - 1) / BN);
  const bool v8 = H3 % 8 == 0 && GW % 8 == 0 && aligned16(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      v8 ? launch(xproj_gemm_dw_kernel<BWD_S, BWD_INF, 8>, grid,
                  xp_smem(BWD_S), s, p)
         : launch(xproj_gemm_dw_kernel<BWD_S, BWD_INF, 1>, grid,
                  xp_smem(BWD_S), s, p));
}
