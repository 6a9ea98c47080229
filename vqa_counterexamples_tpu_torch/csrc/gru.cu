// GRU recurrence, one launch per timestep (see ops/cuda/gru_kernel.py):
// the forward (no mask, one shared or per-gate variational masks) and the
// backward's reverse sweep.
//
// Forward (replaces gru_fwd_pallas, vqa_counterexamples_tpu/ops/pallas/
// gru_kernel.py:183, kernels _fwd_kernel :97 and _fwd_kernel_pg :128).
// Each step is a (B, H) x (H, 3H) product, 17.7 GFLOP at B 512, H 2400,
// whose operands live in L2 (W_hh is 34.6 MB), then the gate math.  On
// the H100 it is neither bound by the tensor cores nor by the bytes the
// blocks pull from L2 (halving those with 2 x 2 clusters and TMA
// multicast did not make it faster), but by latency: of the ring's loads
// and of the epilogue's.  The design:
// - A block owns BM = 64 WG batch rows x BJ hidden units and all three
//   gates of those units (the W rows g H + j0 .. + BJ, g = r, z, n), so
//   the gate math needs nothing from other blocks.  The tile is chosen per
//   (B, H, gates) by the wrapper (gru_kernel.fwd_tile).
// - The masked A operand bf16(h * m_g) is made once a step, in the
//   epilogue of the step that writes h (JAX's hin_scr snapshot), into a
//   ping-pong scratch (2, NG, B, H); the next step streams it as it is.
//   Without a mask A is states[t - 1] itself.
// - One producer warp keeps a ring of STAGES stages full with TMA loads
//   (an A box per gate and a W box per gate, 64B- or 128B-swizzled,
//   zeros past B and H), tracked by full / empty mbarriers.
// - WG consumer warpgroups, 64 rows each, run wgmma m64nBJk16 per gate
//   per 16-deep step (A and W both K-major in shared memory), one group
//   in flight while the next stage is waited for.  NG 1 issues the same
//   three per-gate products on one A tile, so three equal masks give the
//   shared path's bits; every tile sums K in the same order, so every
//   tile gives the same bits.
// - The gate math: the warpgroups' sums go through the idle ring, then
//   each thread takes 8 units of one row and all three gates at a time,
//   so xp, h_{t-1}, the masks, h_t, h_proj and the masked copies move in
//   16-byte accesses along rows (measured faster than the gate math on
//   the accumulators' own layout, whose 4-byte accesses left the
//   epilogue latency-bound).
// Shapes off the TMA rules (H % 8 != 0, unaligned operands) take the same
// template with TMA = false: the producer warp fills the same swizzled
// stages with plain loads.
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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ---------------------------------------------------------------- forward

// One step's operands.  h_prev == nullptr means t == 0 (h_{-1} = 0, so
// h_proj = b_hh and there is no product).  mask == nullptr means ones.
struct FwdStep {
  const bf16* xp_t;     // (B, 3H)
  const bf16* w;        // (3H, H)
  const float* b;       // (3H,)
  const bf16* mask;     // (NG, B, H) or null
  const bf16* h_prev;   // (B, H) or null
  const bf16* a_src;    // A of this step: (NG, B, H) (plain loads)
  int a_z;              // A of this step: its index along the map's dim 2
  bf16* h_out;          // (B, H)
  bf16* hproj_t;        // (B, 3H) or null
  bf16* hm_out;         // (NG, B, H): bf16(h_t * m_g) for the next step,
                        // or null
  int B, H, nk, stages;
};

template <int NG, int WG, int BJ, int BK>
struct FwdTile {
  static constexpr int BM = 64 * WG;
  static constexpr int RB = BK * 2;                  // bytes per tile row
  static constexpr int A_BYTES = BM * RB;            // one gate's A box
  static constexpr int W_BYTES = BJ * RB;            // one gate's W box
  static constexpr int W_SLOT = (W_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGE = NG * A_BYTES + 3 * W_SLOT;
  static constexpr int TX = NG * A_BYTES + 3 * W_BYTES;
  static constexpr int NT = WG * 128 + 32;           // + the producer warp
  static constexpr int LDC = BJ + 4;                 // staged sums' row
  static constexpr int CS = 3 * BM * LDC * 4;        // bytes, in the ring
  __host__ __device__ static constexpr int RING(int stages) {
    return stages * STAGE > CS ? stages * STAGE : CS;
  }
  static_assert(A_BYTES % 1024 == 0 && STAGE % 1024 == 0, "alignment");
  static_assert(BJ % 8 == 0 && (BK == 32 || BK == 64), "tile");
};

// Eight bf16 of a row at q; VEC (H % 8 == 0, 16-byte aligned operands):
// one 16-byte access, else one unit at a time, the n valid ones only
// (the rest read as 0).
template <bool VEC>
__device__ __forceinline__ Pack8 load8(const bf16* q, int n) {
  Pack8 v;
  if constexpr (VEC) {
    v.u = *reinterpret_cast<const uint4*>(q);
  } else {
    for (int e = 0; e < 8; ++e) set_lane8(v, e, e < n ? q[e] : bf16_zero());
  }
  return v;
}

template <bool VEC>
__device__ __forceinline__ void store8(bf16* q, const Pack8& v, int n) {
  if constexpr (VEC) {
    *reinterpret_cast<uint4*>(q) = v.u;
  } else {
    for (int e = 0; e < n; ++e) q[e] = lane8(v, e);
  }
}

// The consumer warpgroups only (the producer warp has left).
template <int WG>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG * 128) : "memory");
}

// The consumer warpgroups of gru_fwd_step_kernel: the product, then the
// gate math.
template <int NG, int WG, int BJ, int BK, bool TMA>
__device__ __forceinline__ void fwd_consume(const FwdStep& p,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty,
                                            int j0, int b0) {
  using Tl = FwdTile<NG, WG, BJ, BK>;
  constexpr int BM = Tl::BM;
  const int S = p.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  {
    // the epilogue's operands start toward L2 while the product runs: the
    // block's rows of xp_t (three gates) and of the masks
    const int per_row = 3 + NG;
    for (int i = threadIdx.x; i < BM * per_row * 2; i += WG * 128) {
      const int r = i / (per_row * 2), a = (i / 2) % per_row, half = i % 2;
      const int b = b0 + r;
      if (b >= p.B) continue;
      const int j = min(j0 + half * (BJ - 1), p.H - 1);
      const void* q =
          a < 3 ? (const void*)(p.xp_t + (size_t)b * 3 * p.H + a * p.H + j)
          : p.mask != nullptr
              ? (const void*)(p.mask + (size_t)(a - 3) * p.B * p.H +
                              (size_t)b * p.H + j)
              : nullptr;
      if (q != nullptr) prefetch_l2(q);
    }
  }
  float acc[3][BJ / 2];
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int e = 0; e < BJ / 2; ++e) acc[g][e] = 0.0f;
  if (p.h_prev != nullptr) {
    for (int kt = 0; kt < p.nk; ++kt) {
      const int s = kt % S;
      mbar_wait(full + s, (kt / S) & 1);
      const unsigned char* st = ring + (size_t)s * Tl::STAGE;
#pragma unroll
      for (int g = 0; g < 3; ++g) fence_acc(acc[g]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const unsigned char* a_tile = st +
              (NG == 3 ? g : 0) * Tl::A_BYTES + wg * 64 * Tl::RB;
          const unsigned char* w_tile = st + NG * Tl::A_BYTES +
              g * Tl::W_SLOT;
          wgmma_bf16_ss<BJ>(acc[g], gmma_desc<Tl::RB>(a_tile) + 2 * kk,
                            gmma_desc<Tl::RB>(w_tile) + 2 * kk);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int g = 0; g < 3; ++g) fence_acc(acc[g]);
      // stage kt - 1 has been read: the producer may refill it
      if (kt > 0) mbar_arrive(empty + (kt - 1) % S);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int g = 0; g < 3; ++g) fence_acc(acc[g]);
  }

  // ---- the gate math.  The sums go through the ring, idle now, so that
  // each thread then takes 8 units of one row at a time: every load and
  // store of the epilogue is 16 bytes wide and a warp's lie along rows
  // (the accumulators' own layout, 2 units of 8 rows a quad, made the
  // epilogue's loads latency-bound).  KB tasks' loads go out before any
  // of them is used.
  constexpr int LDC = Tl::LDC, CH = BJ / 8, NC = WG * 128, KB = 3;
  constexpr int PER = (BM * CH + NC - 1) / NC;
  float* cs = reinterpret_cast<float*>(ring);
  consumers_sync<WG>();   // every warpgroup is done with the ring
  const int rw = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int i = 0; i < BJ / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(cs + (g * BM + rw + 8 * h) * LDC + i * 8 +
                                   (lane % 4) * 2) =
            make_float2(acc[g][4 * i + 2 * h], acc[g][4 * i + 2 * h + 1]);
  consumers_sync<WG>();
  const int H = p.H;
  const size_t gstride = (size_t)p.B * H;
#pragma unroll
  for (int k0 = 0; k0 < PER; k0 += KB) {
    Pack8 xs[KB][3], hp[KB], ms[KB][NG];
#pragma unroll
    for (int k = 0; k < KB && k0 + k < PER; ++k) {
      const int task = threadIdx.x + (k0 + k) * NC;
      const int b = b0 + task / CH, j = j0 + (task % CH) * 8;
      if (task >= BM * CH || b >= p.B || j >= H) continue;
      const int n = min(8, H - j);
      const size_t o = (size_t)b * H + j, x0 = (size_t)b * 3 * H + j;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        xs[k][g] = load8<TMA>(p.xp_t + x0 + g * H, n);
      if (p.h_prev != nullptr) hp[k] = load8<TMA>(p.h_prev + o, n);
      else hp[k].u = make_uint4(0, 0, 0, 0);
      if (p.mask != nullptr)
#pragma unroll
        for (int g = 0; g < NG; ++g)
          ms[k][g] = load8<TMA>(p.mask + g * gstride + o, n);
    }
#pragma unroll
    for (int k = 0; k < KB && k0 + k < PER; ++k) {
      const int task = threadIdx.x + (k0 + k) * NC;
      const int r = task / CH, c0 = (task % CH) * 8;
      const int b = b0 + r, j = j0 + c0;
      if (task >= BM * CH || b >= p.B || j >= H) continue;
      const int n = min(8, H - j);
      const size_t o = (size_t)b * H + j, x0 = (size_t)b * 3 * H + j;
      float sum[3][8];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4* c4 =
            reinterpret_cast<const float4*>(cs + (g * BM + r) * LDC + c0);
        const float4 lo = c4[0], hi = c4[1];
        const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum[g][e] = v[e] + (e < n ? p.b[g * H + j + e] : 0.0f);
      }
      Pack8 hv, pr[3], hm[NG];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float rg = sigmoid(f32(lane8(xs[k][0], e)) + sum[0][e]);
        const float zg = sigmoid(f32(lane8(xs[k][1], e)) + sum[1][e]);
        const float ng = tanhf(f32(lane8(xs[k][2], e)) + rg * sum[2][e]);
        const bf16 h = rn((1.0f - zg) * ng + zg * f32(lane8(hp[k], e)));
        set_lane8(hv, e, h);
#pragma unroll
        for (int g = 0; g < 3; ++g) set_lane8(pr[g], e, rn(sum[g][e]));
        if (p.hm_out != nullptr)
#pragma unroll
          for (int g = 0; g < NG; ++g)
            set_lane8(hm[g], e, rn(f32(h) * f32(lane8(ms[k][g], e))));
      }
      store8<TMA>(p.h_out + o, hv, n);
      if (p.hproj_t != nullptr)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          store8<TMA>(p.hproj_t + x0 + g * H, pr[g], n);
      if (p.hm_out != nullptr)
#pragma unroll
        for (int g = 0; g < NG; ++g)
          store8<TMA>(p.hm_out + g * gstride + o, hm[g], n);
    }
  }
}

// One timestep.  tmA: the A source, dims (H, B, Z) (states, Z = T, or the
// scratch, Z = 2 NG), boxes (BK, BM, 1); tmW: W_hh, dims (H, 3H), boxes
// (BK, BJ).  Unused when TMA is false.
template <int NG, int WG, int BJ, int BK, bool TMA>
__global__ void __launch_bounds__(FwdTile<NG, WG, BJ, BK>::NT, 1)
gru_fwd_step_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmW,
                    const FwdStep p) {
  using Tl = FwdTile<NG, WG, BJ, BK>;
  constexpr int BM = Tl::BM;
  extern __shared__ unsigned char fdyn[];
  // the swizzled tiles need 1024-byte aligned shared addresses
  unsigned char* ring = fdyn + ((1024 - (smem_u32(fdyn) & 1023)) & 1023);
  const int S = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::RING(S));
  uint64_t* empty = full + S;
  const int j0 = blockIdx.x * BJ;
  const int b0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WG * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == WG * 4) {
    // ---- the producer warp: keeps the ring full
    if (p.h_prev == nullptr) return;
    for (int kt = 0; kt < p.nk; ++kt) {
      const int s = kt % S;
      if (kt >= S) mbar_wait(empty + s, ((kt / S) + 1) & 1);
      unsigned char* st = ring + (size_t)s * Tl::STAGE;
      const int k0 = kt * BK;
      if constexpr (TMA) {
        if (lane == 0) {
          mbar_arrive_expect_tx(full + s, Tl::TX);
#pragma unroll
          for (int g = 0; g < NG; ++g)
            tma_load_3d(st + g * Tl::A_BYTES, &tmA, full + s, k0, b0,
                        p.a_z + g);
#pragma unroll
          for (int g = 0; g < 3; ++g)
            tma_load_2d(st + NG * Tl::A_BYTES + g * Tl::W_SLOT, &tmW,
                        full + s, k0, g * p.H + j0);
        }
      } else {
        const size_t gstride = (size_t)p.B * p.H;
        for (int i = lane; i < NG * BM * BK; i += 32) {
          const int g = i / (BM * BK), r = (i / BK) % BM, k = i % BK;
          const int b = b0 + r, kk = k0 + k;
          const bf16 v = b < p.B && kk < p.H
                             ? p.a_src[g * gstride + (size_t)b * p.H + kk]
                             : bf16_zero();
          *reinterpret_cast<bf16*>(st + g * Tl::A_BYTES +
                                   swizzled<Tl::RB>(r, k)) = v;
        }
        for (int i = lane; i < 3 * BJ * BK; i += 32) {
          const int g = i / (BJ * BK), r = (i / BK) % BJ, k = i % BK;
          const int j = j0 + r, kk = k0 + k;
          const bf16 v = j < p.H && kk < p.H
                             ? p.w[((size_t)g * p.H + j) * p.H + kk]
                             : bf16_zero();
          *reinterpret_cast<bf16*>(st + NG * Tl::A_BYTES + g * Tl::W_SLOT +
                                   swizzled<Tl::RB>(r, k)) = v;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + s);
      }
    }
    return;
  }
  fwd_consume<NG, WG, BJ, BK, TMA>(p, ring, full, empty, j0, b0);
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

// The forward's instances, (NG, WG = BM / 64, BJ, BK, TMA), mirrored by
// ops/cuda/gru_kernel.FWD_TILES (the TMA ones) and RAGGED_TILE.
#define VQACX_FWD_TILES(X) \
  X(1, 2, 80, 64, true)    \
  X(3, 2, 80, 64, true)    \
  X(1, 2, 80, 32, true)    \
  X(3, 2, 80, 32, true)    \
  X(1, 1, 40, 64, true)    \
  X(3, 1, 40, 64, true)    \
  X(1, 1, 40, 64, false)   \
  X(3, 1, 40, 64, false)

template <int NG, int WG, int BJ, int BK, bool TMA>
cudaError_t fwd_launch(const CUtensorMap& tmA, const CUtensorMap& tmW,
                       FwdStep p, int T, const bf16* xp, bf16* states,
                       bf16* hproj, bf16* scratch, cudaStream_t s) {
  using Tl = FwdTile<NG, WG, BJ, BK>;
  auto kernel = gru_fwd_step_kernel<NG, WG, BJ, BK, TMA>;
  const size_t smem = 1024 + Tl::RING(p.stages) + 16 * p.stages;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.H + BJ - 1) / BJ, (p.B + Tl::BM - 1) / Tl::BM);
  const size_t step_h = (size_t)p.B * p.H, step_x = 3 * step_h;
  const bool masked = p.mask != nullptr;
  for (int t = 0; t < T; ++t) {
    p.xp_t = xp + t * step_x;
    p.h_prev = t > 0 ? states + (t - 1) * step_h : nullptr;
    p.a_z = masked ? ((t - 1) & 1) * NG : t - 1;
    p.a_src = masked ? scratch + ((t - 1) & 1) * NG * step_h : p.h_prev;
    p.h_out = states + t * step_h;
    p.hproj_t = hproj != nullptr ? hproj + t * step_x : nullptr;
    p.hm_out = masked && t + 1 < T ? scratch + (t & 1) * NG * step_h
                                   : nullptr;
    kernel<<<grid, Tl::NT, smem, s>>>(tmA, tmW, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace vqacx

VQACX_DEFINE_ERROR_STRING

// states[t] = GRU step of states[t-1] (states[-1] = 0) for t in [0, T).
// mask_gates: 0 (no mask: ones), 1 (one (B, H) mask), 3 ((3, B, H), one
// mask per gate r, z, n).  scratch: (2, NG, B, H) bf16 when masked, else
// null.  The tile (bm, bj, bk, tma) must be one of VQACX_FWD_TILES' for
// NG = mask_gates == 3 ? 3 : 1; ``stages`` deep ring.
extern "C" int vqacx_gru_fwd(const void* xp, const void* w, const void* b,
                             const void* mask, int mask_gates, void* states,
                             void* hproj, void* scratch, int T, int B, int H,
                             int bm, int bj, int bk, int tma, int stages,
                             void* stream) {
  using namespace vqacx;
  if (mask_gates != 0 && mask_gates != 1 && mask_gates != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ng = mask_gates == 3 ? 3 : 1;
  const bool masked = mask_gates > 0;
  if (T <= 0 || B <= 0 || H <= 0 || stages < 2 ||
      (masked && scratch == nullptr) || (tma && H % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdStep p{};
  p.w = static_cast<const bf16*>(w);
  p.b = static_cast<const float*>(b);
  p.mask = masked ? static_cast<const bf16*>(mask) : nullptr;
  p.B = B;
  p.H = H;
  p.nk = (H + bk - 1) / bk;
  p.stages = stages;
  bf16* states_ = static_cast<bf16*>(states);
  bf16* scratch_ = masked ? static_cast<bf16*>(scratch) : nullptr;
  CUtensorMap tmA{}, tmW{};
  if (tma) {
    const uint64_t adims[3] = {(uint64_t)H, (uint64_t)B,
                               (uint64_t)(masked ? 2 * ng : T)};
    const uint32_t abox[3] = {(uint32_t)bk, (uint32_t)bm, 1};
    const uint64_t wdims[2] = {(uint64_t)H, (uint64_t)3 * H};
    const uint32_t wbox[2] = {(uint32_t)bk, (uint32_t)bj};
    if (!bf16_tensor_map(&tmA, masked ? (const void*)scratch_ : states_, 3,
                         adims, abox, 2 * bk) ||
        !bf16_tensor_map(&tmW, w, 2, wdims, wbox, 2 * bk))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp_ = static_cast<const bf16*>(xp);
  bf16* hproj_ = static_cast<bf16*>(hproj);
#define VQACX_FWD_CASE(NG_, WG_, BJ_, BK_, TMA_)                          \
  if (ng == NG_ && bm == 64 * WG_ && bj == BJ_ && bk == BK_ &&            \
      (tma != 0) == TMA_)                                                 \
    return static_cast<int>(fwd_launch<NG_, WG_, BJ_, BK_, TMA_>(         \
        tmA, tmW, p, T, xp_, states_, hproj_, scratch_, s));
  VQACX_FWD_TILES(VQACX_FWD_CASE)
#undef VQACX_FWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
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
