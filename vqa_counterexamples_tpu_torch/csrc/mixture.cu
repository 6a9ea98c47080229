// Frozen answer head + softmax, its (M, A) output written once (see
// ops/cuda/mixture_kernel.py).
//
// A cluster of CL CTAs owns 64 rows of z; CTA c of it owns the answer
// columns [c CW, (c + 1) CW), CW a multiple of 256 (CL, CW and the ring's
// depth are the wrapper's plan, mixture_kernel.mixture_plan: at the CX
// path's A 2000, four CTAs of 512 and 3 stages).  In each CTA:
// - one producer warp: the CTA's bias slice into shared memory, then TMA
//   loads of its z rows once (64 x dz, in 64-deep chunks, 128B-swizzled,
//   zeros past M and dz), then W (A x dz, read from L2 by every row block)
//   streamed as 256-answer x 64-deep stages (32 KB: half the stages of
//   128-answer ones, which took 12 us a CTA to stream where these take
//   about 8) through a ring of full / empty mbarriers;
// - two consumer warpgroups share each stage, warpgroup w the answers
//   128 w .. 128 w + 127 of the tile: wgmma m64n128k16, z as A and the W
//   stage as B (both K-major); the tile's logits l = bf16(bf16(acc) + b) go
//   into shared memory (64-answer panels of 64 x 64, 128B-swizzled: the
//   fragment's 4-byte stores hit distinct banks) while each thread keeps
//   the max of its rows.  (Tiles taken in turn by the warpgroups would
//   have one warpgroup wait on a stage's parity a whole phase ahead.)
// - the row max over the CTA's columns goes through shared memory to the
//   cluster (distributed shared memory, one cluster barrier), so every CTA
//   holds the max over all A answers before it computes any u, as JAX's
//   rounding points need (an online softmax would not keep them);
// - u = bf16(exp(bf16(l - max))) in place, a warp along each row, 16 bytes
//   a lane; the f32 row sum in one fixed order (lanes over the row's
//   8-answer chunks in order, then a fixed shuffle tree, then the CTAs in
//   rank order), so reruns are bit-equal;
// - out = bf16(u * bf16(1 / s)) in place, then TMA stores of the 64 x 64
//   panels (their 128B swizzle is the tensor map's): the only write of the
//   output, and nothing of it is read back.  (Where A % 8 != 0, off TMA's
//   strides, the lanes store it along rows.)
// The elementwise steps run on bf16 pairs (add, subtract, max,
// multiply), each rounding the exact result once.  JAX's f32 op and
// conversion round twice, but f32's 24 bits are at least 2 * 8 + 2, so
// for bf16 operands the double rounding gives the correctly rounded
// result (Figueroa's bound for +, - and *): the two agree bit for bit on
// normal results.  (Results in the subnormal range, a row whose logits
// span more than about 87, are not exercised by the tests.)
// The ragged answer edge is masked (no -1e9 bias); dz % 8 != 0 (off TMA's
// 16-byte strides) takes the same template with TMA = false, its producer
// warp filling the same swizzled stages by hand.
#include "common.cuh"

namespace vqacx {
namespace {

constexpr int BM = 64;              // z rows per CTA: one wgmma M
constexpr int BN = 256;             // answers per W tile
constexpr int WN = 128;             // of them per warpgroup: wgmma N
constexpr int BK = 64;              // depth per chunk: 128-byte rows
constexpr int WG = 2;               // consumer warpgroups
constexpr int NT = WG * 128 + 32;   // + the producer warp
constexpr int PANEL = BM * BK * 2;  // 8 KB: a z chunk, a panel of l
constexpr int WSTAGE = BN * BK * 2; // 32 KB

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(static_cast<int>(0xff800000u));
}

struct MixParams {
  const bf16* z;      // (M, D)
  const bf16* w;      // (A, D)
  const bf16* bias;   // (A,)
  bf16* out;          // (M, A)
  int M, D, A;
  int cw;             // answer columns per CTA, a multiple of BN
  int kc;             // 64-deep chunks of D
  int stages;         // W ring depth
  bool tma_out;       // A % 8 == 0, out 16-byte aligned: TMA stores
};

// Shared memory after the 1024-byte aligned base: z chunks, l panels, the
// W ring, f32 row vectors, the CTA's bias slice (bf16) and the mbarriers.
__host__ __device__ constexpr int mix_smem(int kc, int cw, int stages) {
  return kc * PANEL + (cw / 64) * PANEL + stages * WSTAGE +
         (WG + 3) * BM * 4 + cw * 2 + (1 + 2 * stages) * 8;
}

template <int CL, bool TMA>
__global__ void __launch_bounds__(NT, 1)
mixture_kernel(const __grid_constant__ CUtensorMap tmZ,
               const __grid_constant__ CUtensorMap tmW,
               const __grid_constant__ CUtensorMap tmO, const MixParams p) {
  extern __shared__ unsigned char mdyn[];
  unsigned char* zs = mdyn + ((1024 - (smem_u32(mdyn) & 1023)) & 1023);
  const int KC = p.kc, S = p.stages;
  unsigned char* lbuf = zs + KC * PANEL;
  unsigned char* ring = lbuf + (p.cw / 64) * PANEL;
  float* red = reinterpret_cast<float*>(ring + S * WSTAGE);  // [WG][BM]
  float* xmax = red + WG * BM;   // this CTA's row max, read by the cluster
  float* xsum = xmax + BM;       // this CTA's row sum, read by the cluster
  float* gmax = xsum + BM;       // the row max over every answer
  bf16* bias_s = reinterpret_cast<bf16*>(gmax + BM);  // bias[c0 ..), 0 past A
  uint64_t* zbar = reinterpret_cast<uint64_t*>(bias_s + p.cw);
  uint64_t* full = zbar + 1;
  uint64_t* empty = full + S;

  const unsigned rank = blockIdx.x % CL;
  const int r0 = (blockIdx.x / CL) * BM;
  const int c0 = rank * p.cw;
  const int ncol = max(0, min(p.A - c0, p.cw));
  const int ntiles = (ncol + BN - 1) / BN;
  const int nload = ntiles * KC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(zbar, 2);   // z's copies, and the producer warp's bias
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WG * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG * 4) {
    // ---- the producer warp: the bias slice, z once, then the W ring
    for (int i = lane; i < p.cw; i += 32)
      bias_s[i] = c0 + i < p.A ? p.bias[c0 + i] : bf16_zero();
    __syncwarp();
    if (lane == 0) mbar_arrive(zbar);
    if constexpr (TMA) {
      if (lane == 0) {
        mbar_arrive_expect_tx(zbar, KC * PANEL);
        for (int kc = 0; kc < KC; ++kc)
          tma_load_2d(zs + kc * PANEL, &tmZ, zbar, kc * BK, r0);
        for (int li = 0; li < nload; ++li) {
          const int s = li % S;
          if (li >= S) mbar_wait(empty + s, ((li / S) + 1) & 1);
          mbar_arrive_expect_tx(full + s, WSTAGE);
          tma_load_2d(ring + s * WSTAGE, &tmW, full + s, (li % KC) * BK,
                      c0 + (li / KC) * BN);
        }
      }
    } else {
      for (int i = lane; i < KC * BM * BK; i += 32) {
        const int kc = i / (BM * BK), r = (i / BK) % BM, k = i % BK;
        const int m = r0 + r, d = kc * BK + k;
        *reinterpret_cast<bf16*>(zs + kc * PANEL + swizzled<128>(r, k)) =
            m < p.M && d < p.D ? p.z[(size_t)m * p.D + d] : bf16_zero();
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(zbar);
      for (int li = 0; li < nload; ++li) {
        const int s = li % S;
        if (li >= S) mbar_wait(empty + s, ((li / S) + 1) & 1);
        const int a0 = c0 + (li / KC) * BN, d0 = (li % KC) * BK;
        for (int i = lane; i < BN * BK; i += 32) {
          const int r = i / BK, k = i % BK;
          const int a = a0 + r, d = d0 + k;
          *reinterpret_cast<bf16*>(ring + s * WSTAGE + swizzled<128>(r, k)) =
              a < p.A && d < p.D ? p.w[(size_t)a * p.D + d] : bf16_zero();
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + s);
      }
    }
  } else {
    // ---- the consumer warpgroups: logits into shared memory, row max
    const int wg = warp / 4;
    const int qrow = (warp % 4) * 16 + lane / 4;   // and qrow + 8
    const int qcol = 2 * (lane % 4);
    const __nv_bfloat162 ninf2 = __floats2bfloat162_rn(neg_inf(), neg_inf());
    __nv_bfloat162 rmax[2] = {ninf2, ninf2};
    mbar_wait(zbar, 0);
    for (int tile = 0; tile < ntiles; ++tile) {
      float acc[WN / 2];
      for (int kc = 0; kc < KC; ++kc) {
        const int li = tile * KC + kc;
        const int s = li % S;
        mbar_wait(full + s, (li / S) & 1);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_bf16_ss<WN>(acc, gmma_desc<128>(zs + kc * PANEL) + 2 * kk,
                            gmma_desc<128>(ring + s * WSTAGE + wg * WN * 128)
                                + 2 * kk,
                            kc > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_acc(acc);
        if (kc > 0) mbar_arrive(empty + (li - 1) % S);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive(empty + (tile * KC + KC - 1) % S);
      // l = bf16(bf16(acc) + b) in packed bf16 pairs (one rounding each:
      // the pair ops round the exact sum), the running max likewise; the
      // bias pairs are all loaded before the first store to lbuf
      __nv_bfloat162 bv[WN / 8];
#pragma unroll
      for (int i = 0; i < WN / 8; ++i)
        bv[i] = *reinterpret_cast<const __nv_bfloat162*>(
            bias_s + tile * BN + wg * WN + 8 * i + qcol);
      const bool whole = c0 + (tile + 1) * BN <= p.A;
#pragma unroll
      for (int i = 0; i < WN / 8; ++i) {
        const int col = tile * BN + wg * WN + 8 * i + qcol;  // CTA-local
        const int a = c0 + col;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 l = __hadd2(
              __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]),
              bv[i]);
          if (whole) {
            rmax[h] = __hmax2(rmax[h], l);
          } else {
            if (a < p.A) rmax[h].x = __hmax(rmax[h].x, l.x);
            if (a + 1 < p.A) rmax[h].y = __hmax(rmax[h].y, l.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              lbuf + (col / 64) * PANEL +
              swizzled<128>(qrow + 8 * h, col % 64)) = l;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = fmaxf(f32(rmax[h].x), f32(rmax[h].y));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      if (lane % 4 == 0) red[wg * BM + qrow + 8 * h] = m;
    }
    named_sync<1, WG * 128>();
    if (threadIdx.x < BM) {
      float m = red[threadIdx.x];
      for (int g = 1; g < WG; ++g) m = fmaxf(m, red[g * BM + threadIdx.x]);
      xmax[threadIdx.x] = m;
    }
  }

  cluster_sync();   // every CTA's xmax is written (1)
  constexpr int RPW = BM / (WG * 4);   // rows per consumer warp
  const int nch = (ncol + 7) / 8;      // 8-answer chunks of the CTA's row
  float inv[RPW];
  if (warp < WG * 4) {
    if (threadIdx.x < BM) {
      float m = neg_inf();
      for (unsigned q = 0; q < CL; ++q)
        m = fmaxf(m, ld_cluster_f32(xmax + threadIdx.x, q));
      gmax[threadIdx.x] = m;
    }
    named_sync<1, WG * 128>();
    // u in place and the row sums: a warp along each of its rows, 16
    // bytes a lane; u = bf16(exp(bf16(l - max))) with the subtraction a
    // bf16 pair op (one rounding of the exact difference), exp in f32 and
    // one conversion a pair; the f32 sum in chunk order, then a fixed
    // shuffle tree
    for (int i = 0; i < RPW; ++i) {
      const int row = warp * RPW + i;
      const __nv_bfloat162 mx2 = __float2bfloat162_rn(gmax[row]);
      float s = 0.0f;
      for (int ch = lane; ch < nch; ch += 32) {
        const int col = ch * 8;
        Pack8* q = reinterpret_cast<Pack8*>(
            lbuf + (col / 64) * PANEL + swizzled<128>(row, col % 64));
        Pack8 v = *q;
        const bool whole = col + 8 <= ncol;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 x = __bfloat1622float2(__hsub2(pair8(v, k), mx2));
          __nv_bfloat162 u = __floats2bfloat162_rn(expf(x.x), expf(x.y));
          if (!whole) {
            if (col + 2 * k >= ncol) u.x = bf16_zero();
            if (col + 2 * k + 1 >= ncol) u.y = bf16_zero();
          }
          const float2 uf = __bfloat1622float2(u);
          s += uf.x;
          s += uf.y;
          set_pair8(v, k, u);
        }
        *q = v;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) xsum[row] = s;
    }
  }
  cluster_sync();   // every CTA's xsum is written (2)
  if (warp < WG * 4) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = warp * RPW + i;
      float v[CL];
#pragma unroll
      for (int q = 0; q < CL; ++q) v[q] = ld_cluster_f32(xsum + row, q);
      float s = 0.0f;
#pragma unroll
      for (int q = 0; q < CL; ++q) s += v[q];
      inv[i] = f32(rn(1.0f / s));
    }
  }
  cluster_arrive();   // done reading the cluster's shared memory (3)
  if (warp < WG * 4) {
    // out = bf16(u * bf16(1 / s)) (a bf16 pair product: exact, one
    // rounding): in place, then one TMA store per panel (rows past M and
    // answers past A clipped), or stored along rows where A % 8 != 0
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int row = warp * RPW + i;
      const int m = r0 + row;
      const __nv_bfloat162 inv2 = __float2bfloat162_rn(inv[i]);
      bf16* orow = p.out + (size_t)m * p.A + c0;
      for (int ch = lane; ch < nch; ch += 32) {
        const int col = ch * 8;
        Pack8* q = reinterpret_cast<Pack8*>(
            lbuf + (col / 64) * PANEL + swizzled<128>(row, col % 64));
        Pack8 v = *q;
#pragma unroll
        for (int k = 0; k < 4; ++k) set_pair8(v, k, __hmul2(pair8(v, k), inv2));
        if (p.tma_out) {
          *q = v;
        } else if (m < p.M) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (col + e < ncol) orow[col + e] = lane8(v, e);
        }
      }
    }
    if (p.tma_out) {
      fence_proxy_async();
      named_sync<1, WG * 128>();
      if (threadIdx.x == 0) {
        for (int pn = 0; pn < (ncol + 63) / 64; ++pn)
          tma_store_2d(&tmO, lbuf + pn * PANEL, c0 + pn * 64, r0);
        tma_store_commit();
        tma_store_wait_read();   // the panels stay until TMA has read them
      }
    }
  }
  cluster_wait();   // no CTA leaves while another may still read it
}

template <int CL, bool TMA>
cudaError_t mix_launch(const CUtensorMap& tmZ, const CUtensorMap& tmW,
                       const CUtensorMap& tmO, const MixParams& p,
                       size_t smem, cudaStream_t s) {
  auto kernel = mixture_kernel<CL, TMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL * ((p.M + BM - 1) / BM));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tmZ, tmW, tmO, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// Shared memory (bytes, with the alignment slack) of one CTA for the plan
// (kc chunks of 64 deep, cw answer columns, stages), for the wrapper's
// plan and checks.
extern "C" int vqacx_mixture_smem(int kc, int cw, int stages) {
  return 1024 + vqacx::mix_smem(kc, cw, stages);
}

// probs = softmax(z @ w^T + bias) per row, JAX's rounding points; the plan
// (cl CTAs a cluster, cw answers each, a W ring of ``stages``) is the
// wrapper's (mixture_kernel.mixture_plan); cl is 2, 4 or 8.
extern "C" int vqacx_mixture_fwd(const void* z, int M, int D, const void* w,
                                 const void* bias, int A, void* out, int cl,
                                 int cw, int stages, void* stream) {
  using namespace vqacx;
  if (M <= 0 || D <= 0 || A <= 0 || cw % BN != 0 || stages < 2 ||
      cl * cw < A)
    return static_cast<int>(cudaErrorInvalidValue);
  MixParams p{};
  p.z = static_cast<const bf16*>(z);
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.out = static_cast<bf16*>(out);
  p.M = M;
  p.D = D;
  p.A = A;
  p.cw = cw;
  p.kc = (D + BK - 1) / BK;
  p.stages = stages;
  p.tma_out = A % 8 == 0 && aligned16(out);
  const bool tma = D % 8 == 0 && aligned16(z) && aligned16(w);
  CUtensorMap tmZ{}, tmW{}, tmO{};
  if (p.tma_out) {
    const uint64_t odims[2] = {(uint64_t)A, (uint64_t)M};
    const uint32_t obox[2] = {64, BM};
    if (!bf16_tensor_map(&tmO, out, 2, odims, obox, 128))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tma) {
    const uint64_t zdims[2] = {(uint64_t)D, (uint64_t)M};
    const uint32_t zbox[2] = {BK, BM};
    const uint64_t wdims[2] = {(uint64_t)D, (uint64_t)A};
    const uint32_t wbox[2] = {BK, BN};
    if (!bf16_tensor_map(&tmZ, z, 2, zdims, zbox, 128) ||
        !bf16_tensor_map(&tmW, w, 2, wdims, wbox, 128))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = 1024 + mix_smem(p.kc, cw, stages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VQACX_MIX_CASE(CL_)                                              \
  if (cl == CL_)                                                         \
    return static_cast<int>(                                             \
        tma ? mix_launch<CL_, true>(tmZ, tmW, tmO, p, smem, s)           \
            : mix_launch<CL_, false>(tmZ, tmW, tmO, p, smem, s));
  VQACX_MIX_CASE(2)
  VQACX_MIX_CASE(4)
  VQACX_MIX_CASE(8)
#undef VQACX_MIX_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
