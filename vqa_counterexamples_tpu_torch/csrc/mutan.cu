// MUTAN's rank-R Tucker fusion (see ops/cuda/mutan_kernel.py):
//   out = sum_r (x_v @ Wv_r^T + bv_r) * (x_q @ Wq_r^T + bq_r)
// with neither (B, R * dmm) projection leaving the chip.
//
// One launch of clusters (the wrapper's plan, mutan_kernel.tucker_plan).  A
// cluster owns a 64 x 64 output tile (batch rows x dmm columns); its CL
// CTAs split the ranks, RG contiguous ranks each.  For each of its ranks a
// CTA (one warpgroup) streams (x chunk, W chunk) pairs, 64 x 64 bf16 each,
// through a cp.async ring into wgmma m64n64k16 with f32 accumulators in
// registers, the two projections in turn; then it adds the f32 biases,
// multiplies, and stages the rank's product tile in its shared memory.
// After a cluster barrier each CTA sums its share of the tile's rows over
// all R ranks in order (r = 0, 1, ..., as JAX's out_ref += prod does),
// reading the other CTAs' products through distributed shared memory, and
// writes the output once, in f32.  No atomics: reruns are bit-equal.
// Copies are 16 bytes where dh % 8 == 0 (rows of 720 bytes at dh 360),
// else 4 bytes (MutanAtt's classifier: rows of 1,240 and 620 bytes, off
// TMA's and cp.async's 16-byte strides), else plain loads.
#include "common.cuh"

namespace vqacx {
namespace {

constexpr int NT = 128;
constexpr int STAGE = 2 * 8192;   // an x tile and a W tile, 64 x 64 bf16
constexpr int S = 2;              // the ring's depth: the smallest, so that
                                  // 3 CTAs share an SM (deeper measured
                                  // slower)
constexpr int LDP = 72;           // f32 row stride of a staged product
                                  // tile (+ 8: rows 8 apart hit other banks)
constexpr int PTILE = 64 * LDP * 4;

// Shared memory (bytes, with the 1024-byte alignment slack).
__host__ __device__ constexpr int mutan_bytes(int rg) {
  return 1024 + S * STAGE + rg * PTILE;
}

struct MutanParams {
  const bf16* xv;    // (B, dhv)
  const bf16* xq;    // (B, dhq)
  const bf16* wv;    // (R * dmm, dhv)
  const float* bv;   // (R * dmm,)
  const bf16* wq;    // (R * dmm, dhq)
  const float* bq;   // (R * dmm,)
  float* out;        // (B, dmm)
  int B, dhv, dhq, R, dmm;
  int cl, rg;
};

// a (64 x 64) += x chunk (64 x 64) W chunk (64 x 64)^T, both K-major and
// 128B-swizzled in the stage; ``acc`` 0 overwrites.
__device__ __forceinline__ void mma_stage(float (&a)[32],
                                          const unsigned char* st, bool acc) {
  fence_acc(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_bf16_ss<64>(a, gmma_desc<128>(st) + 2 * kk,
                      gmma_desc<128>(st + 8192) + 2 * kk, acc || kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(a);
}

template <int VEC>
__global__ void __launch_bounds__(NT) mutan_fwd_kernel(const MutanParams p) {
  extern __shared__ unsigned char dyn[];
  unsigned char* ring = dyn + ((1024 - (smem_u32(dyn) & 1023)) & 1023);
  float* prod = reinterpret_cast<float*>(ring + S * STAGE);  // [RG][64][LDP]
  const unsigned crank = blockIdx.x % p.cl;
  const int tile = blockIdx.x / p.cl;
  const int NTL = (p.dmm + 63) / 64;
  const int n0 = (tile % NTL) * 64, b0 = (tile / NTL) * 64;
  const int r_lo = crank * p.rg;
  const int nr = max(0, min(p.rg, p.R - r_lo));
  const int KV = (p.dhv + 63) / 64, KC = KV + (p.dhq + 63) / 64;
  const int nit = nr * KC;
  auto load = [&](int it) {
    if (it < nit) {
      const int r = r_lo + it / KC, c = it % KC;
      unsigned char* st = ring + (it % S) * STAGE;
      const bool v = c < KV;
      const int dh = v ? p.dhv : p.dhq, k0 = (v ? c : c - KV) * 64;
      load_box<VEC, NT>(st, v ? p.xv : p.xq, dh, b0, p.B, k0, dh, 64);
      const bf16* w = (v ? p.wv : p.wq) + (size_t)r * p.dmm * dh;
      load_box<VEC, NT>(st + 8192, w, dh, n0, p.dmm, k0, dh, 64);
    }
    cp_async_commit();
  };
  for (int it = 0; it < S - 1; ++it) load(it);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qrow = warp * 16 + lane / 4;   // rows qrow, qrow + 8
  const int qcol = 2 * (lane % 4);         // columns 8 i + qcol (+ 1)
  float av[32], aq[32];
  for (int it = 0; it < nit; ++it) {
    cp_async_wait_upto(S - 2);   // this thread's copies of stage it
    fence_proxy_async();
    __syncthreads();   // everyone's; stage it - 1 is no longer read
    load(it + S - 1);
    const int c = it % KC;
    const unsigned char* st = ring + (it % S) * STAGE;
    if (c < KV)
      mma_stage(av, st, c > 0);
    else
      mma_stage(aq, st, c > KV);
    if (c != KC - 1) continue;
    // the rank's product tile: (hv + bv) * (hq + bq), staged for the sum
    const int j = it / KC;
    const size_t rb = (size_t)(r_lo + j) * p.dmm;
    float* pj = prod + j * 64 * LDP;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 8 * i + qcol;
      float bvv[2], bqv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = n0 + col + e < p.dmm;
        bvv[e] = ok ? p.bv[rb + n0 + col + e] : 0.0f;
        bqv[e] = ok ? p.bq[rb + n0 + col + e] : 0.0f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 4 * i + 2 * h;
        *reinterpret_cast<float2*>(pj + (qrow + 8 * h) * LDP + col) =
            make_float2(__fmul_rn(av[e] + bvv[0], aq[e] + bqv[0]),
                        __fmul_rn(av[e + 1] + bvv[1], aq[e + 1] + bqv[1]));
      }
    }
  }
  cluster_sync();   // every rank's product tile is staged
  // this CTA's rows of the tile: the R products in rank order (8 remote
  // loads go out before the sum waits on any)
  const int rows = (64 + p.cl - 1) / p.cl;
  for (int i = threadIdx.x; i < rows * 64; i += NT) {
    const int row = crank * rows + i / 64, col = i % 64;
    if (row >= 64) break;   // the last CTA's rows end at 64
    const float* q = prod + row * LDP + col;
    float s = 0.0f;
    for (int r0 = 0; r0 < p.R; r0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int r = r0 + u;
        v[u] = r < p.R ? ld_cluster_f32(q + (r % p.rg) * 64 * LDP, r / p.rg)
                       : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (r0 + u < p.R) s += v[u];
    }
    if (b0 + row < p.B && n0 + col < p.dmm)
      p.out[(size_t)(b0 + row) * p.dmm + n0 + col] = s;
  }
  cluster_sync();   // no CTA leaves while another may still read it
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// Shared memory of a CTA (bytes) for ``rg`` ranks; for the wrapper's plan
// and its check.
extern "C" size_t vqacx_mutan_smem(int rg) {
  return (size_t)vqacx::mutan_bytes(rg);
}

// The fusion (see the note at the top) with the wrapper's plan: clusters
// of ``cl`` CTAs, ``rg`` ranks each (cl = ceil(R / rg)).
extern "C" int vqacx_mutan_fwd(const void* xv, const void* xq, const void* wv,
                               const void* bv, const void* wq, const void* bq,
                               void* out, int B, int dhv, int dhq, int R,
                               int dmm, int cl, int rg, void* stream) {
  using namespace vqacx;
  if (B <= 0 || dhv <= 0 || dhq <= 0 || R <= 0 || dmm <= 0 || cl < 1 ||
      cl > 8 || rg < 1 || (R + rg - 1) / rg != cl)
    return static_cast<int>(cudaErrorInvalidValue);
  const MutanParams p{static_cast<const bf16*>(xv),
                      static_cast<const bf16*>(xq),
                      static_cast<const bf16*>(wv),
                      static_cast<const float*>(bv),
                      static_cast<const bf16*>(wq),
                      static_cast<const float*>(bq),
                      static_cast<float*>(out), B, dhv, dhq, R, dmm, cl, rg};
  const uintptr_t all = reinterpret_cast<uintptr_t>(xv) |
                        reinterpret_cast<uintptr_t>(xq) |
                        reinterpret_cast<uintptr_t>(wv) |
                        reinterpret_cast<uintptr_t>(wq);
  const int vec = dhv % 8 == 0 && dhq % 8 == 0 && (all & 15u) == 0  ? 8
                  : dhv % 2 == 0 && dhq % 2 == 0 && (all & 3u) == 0 ? 2
                                                                    : 1;
  auto k = vec == 8   ? mutan_fwd_kernel<8>
           : vec == 2 ? mutan_fwd_kernel<2>
                      : mutan_fwd_kernel<1>;
  const size_t smem = mutan_bytes(rg);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(k),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * ((B + 63) / 64) * ((dmm + 63) / 64));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = static_cast<int>(cudaLaunchKernelEx(&cfg, k, p));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
