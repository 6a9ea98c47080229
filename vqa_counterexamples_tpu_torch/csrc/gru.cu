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
// Backward (replaces gru_bwd_pallas, gru_kernel.py:423, kernels
// _bwd_kernel / _bwd_kernel_pg): one launch per timestep, T in all.  The
// launch for step s first finishes the carry of step s + 1, dh += sum_g
// bf16(dh_proj_g) @ W_g * mask_g (skipped for s = T - 1), then, in the
// same block's epilogue, recomputes r, z, n of step s from the bf16
// residuals, emits its gate cotangents and leaves g * z in dh.  Step s's
// product needs whole dh_proj rows of step s + 1, a grid-wide dependency:
// hence a launch per step.  Each is the forward's product transposed, the
// same FLOPs on the same L2-resident W_hh, and takes the forward's recipe:
// - A block owns BM = 64 WG batch rows x BN hidden units of dh and one
//   f32 accumulator per gate over a K loop of depth H per gate, so the
//   gate epilogue needs nothing from other blocks.  The tile is chosen per
//   (B, H) by the wrapper (gru_kernel.bwd_tile): the fewest L2 bytes per
//   SM (B 512: one wave of 120 blocks of 128 x 80).  Nine warps a block
//   leave 168 registers a thread (three warps share an SM quarter's
//   register file): 128 x 80 takes 166, a wider tile spills.
// - One producer warp keeps a ring of 32-deep stages full with TMA loads:
//   per gate an A box (dh_proj_g of step s + 1, K-major, 64B-swizzled;
//   the map's gate dimension puts zeros past H) and a W_g box, read
//   MN-major (units contiguous) as BN / 16 chunks of 16 units, 32B-
//   swizzled, through a map whose chunk dimension is 32 bytes apart: one
//   box a gate, and no bytes past the tile.
// - WG consumer warpgroups, 64 rows each, run wgmma m64nBNk16 per gate
//   with W through the transposed-B (MN-major) descriptor, one group in
//   flight while the next stage is waited for.  Every tile sums K in the
//   same order, so every tile gives the same bits.
// - The gate math as the forward's: the sums go through the idle ring,
//   then each thread takes 8 units of one row, so dh, ds, xp, h_proj,
//   h_{t-1}, the masks, dxp and dh_proj move in 16-byte accesses; the
//   epilogue's operands are prefetched to L2 while the product runs.
// The back product is bound, like the forward's, by what the blocks pull
// from L2 (a 128 x 80 block reads 3 MB a step), not by the tensor cores;
// the gate math follows it in each block, not overlapped with it.
// Shapes off the TMA rules (H % 16 != 0: W's chunks are 16 units wide;
// unaligned operands) take the same template with TMA = false.
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

// One reverse step's operands.  dhp_next == nullptr means s == T - 1 (no
// carry in, so no product); h_prev == nullptr means s == 0.  mask ==
// nullptr means ones; gstride is 0 for one shared (B, H) mask.
struct BwdStep {
  const bf16* dhp_next;  // (B, 3H): dh_proj of step s + 1 (tmA's when TMA)
  const bf16* w;         // (3H, H) (tmW's when TMA)
  const bf16* mask;      // (B, H) or (3, B, H), or null
  size_t gstride;
  float* dh;             // (B, H) f32 carry, in and out
  const bf16* ds;        // (B, H)
  const bf16* xp;        // (B, 3H)
  const bf16* hp;        // (B, 3H)
  const bf16* h_prev;    // (B, H) or null
  bf16* dxp;             // (B, 3H)
  bf16* dhp;             // (B, 3H)
  int a_t;               // s + 1: A's index along the map's dim 3
  int B, H, nk, stages;
};

template <int WG, int BN>
struct BwdTile {
  static constexpr int BM = 64 * WG;
  static constexpr int BK = 32;                      // depth a stage, a gate
  static constexpr int A_BYTES = BM * BK * 2;        // one gate's A box
  static constexpr int W_CHUNK = BK * 32;            // 16 units x BK rows
  static constexpr int W_BYTES = BN / 16 * W_CHUNK;  // one gate's W box
  static constexpr int STAGE = 3 * A_BYTES + 3 * W_BYTES;
  static constexpr int NT = WG * 128 + 32;           // + the producer warp
  static constexpr int LDC = BN + 4;                 // staged sums' row
  static constexpr int CS = 3 * BM * LDC * 4;        // bytes, in the ring
  __host__ __device__ static constexpr int RING(int stages) {
    return stages * STAGE > CS ? stages * STAGE : CS;
  }
  static_assert(A_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "alignment");
  static_assert(BN % 16 == 0, "W's 32B-swizzled chunks are 16 units wide");
};

// Eight f32 of a row at q, as load8 / store8.
template <bool VEC>
__device__ __forceinline__ void load8f(const float* q, int n,
                                       float (&v)[8]) {
  if constexpr (VEC) {
    const float4 lo = reinterpret_cast<const float4*>(q)[0];
    const float4 hi = reinterpret_cast<const float4*>(q)[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
    for (int e = 0; e < 8; ++e) v[e] = e < n ? q[e] : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void store8f(float* q, const float (&v)[8],
                                        int n) {
  if constexpr (VEC) {
    reinterpret_cast<float4*>(q)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(q)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    for (int e = 0; e < n; ++e) q[e] = v[e];
  }
}

// The consumer warpgroups of gru_bwd_step_kernel: the back product of step
// s + 1, then step s's gate math.  Per (b, k), in JAX's order:
//   dh += acc_r * mask_r;  dh += acc_z * mask_z;  dh += acc_n * mask_n
//   g = ds + dh;  dxp = bf16([dsr, dsz, dsn]);  dh_proj = bf16([dsr, dsz,
//   dhn]);  dh <- g * z
template <int WG, int BN, bool TMA>
__device__ __forceinline__ void bwd_consume(const BwdStep& p,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty,
                                            int n0, int b0) {
  using Tl = BwdTile<WG, BN>;
  constexpr int BM = Tl::BM;
  const int S = p.stages, H = p.H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const bool carry = p.dhp_next != nullptr;
  constexpr int LDC = Tl::LDC, CH = BN / 8, NC = WG * 128, KB = 2;
  constexpr int PER = (BM * CH + NC - 1) / NC;
  float* cs = reinterpret_cast<float*>(ring);
  if (carry) {
    // the epilogue's operands, cold in device memory, start toward L2 now
    // and arrive while the product runs: per row, the first, middle and
    // last units of ds, h_prev, the masks, the three gates of xp and
    // h_proj, and dh
    constexpr int PA = 12;
    for (int i = threadIdx.x; i < BM * PA * 3; i += NC) {
      const int r = i / (PA * 3), a = (i / 3) % PA, part = i % 3;
      const int b = b0 + r;
      if (b >= p.B) continue;
      const int k = min(n0 + part * (BN - 1) / 2, H - 1);
      const size_t o = (size_t)b * H + k, x0 = (size_t)b * 3 * H + k;
      const void* q = nullptr;
      if (a == 0) q = p.ds + o;
      else if (a == 1) q = p.h_prev != nullptr ? p.h_prev + o : nullptr;
      else if (a < 5) q = p.mask != nullptr ? p.mask + (a - 2) * p.gstride + o
                                            : nullptr;
      else if (a < 8) q = p.xp + x0 + (size_t)(a - 5) * H;
      else if (a < 11) q = p.hp + x0 + (size_t)(a - 8) * H;
      else q = p.dh + o;
      if (q != nullptr) prefetch_l2(q);
    }
    float acc[3][BN / 2];
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[g][e] = 0.0f;
    for (int kt = 0; kt < p.nk; ++kt) {
      const int s = kt % S;
      mbar_wait(full + s, (kt / S) & 1);
      const unsigned char* st = ring + (size_t)s * Tl::STAGE;
#pragma unroll
      for (int g = 0; g < 3; ++g) fence_acc(acc[g]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Tl::BK / 16; ++kk) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          // A: this warpgroup's dh_proj_g rows, K-major (64-byte rows);
          // W_g: BK depth rows, MN-major (16-unit chunks of 32-byte rows)
          const unsigned char* a_tile = st + g * Tl::A_BYTES + wg * 64 * 64;
          const unsigned char* w_tile = st + 3 * Tl::A_BYTES +
              g * Tl::W_BYTES;
          wgmma_bf16_ss<BN, 0, 1>(acc[g], gmma_desc<64>(a_tile) + 2 * kk,
                                  gmma_desc_mn<32>(w_tile, Tl::W_CHUNK) +
                                      32 * kk);
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
    // the sums go through the ring, idle now, so that each thread then
    // takes 8 units of one row at a time in 16-byte accesses
    consumers_sync<WG>();   // every warpgroup is done with the ring
    const int rw = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int g = 0; g < 3; ++g)
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(cs + (g * BM + rw + 8 * h) * LDC +
                                     i * 8 + (lane % 4) * 2) =
              make_float2(acc[g][4 * i + 2 * h], acc[g][4 * i + 2 * h + 1]);
    consumers_sync<WG>();
  }

  // ---- the gate math: KB tasks' loads go out before any of them is used
  const size_t h3 = (size_t)3 * H;
#pragma unroll
  for (int k0 = 0; k0 < PER; k0 += KB) {
    float dv[KB][8];
    Pack8 dsv[KB], xs[KB][3], hs[KB][3], hv[KB], ms[KB][3];
#pragma unroll
    for (int k = 0; k < KB && k0 + k < PER; ++k) {
      const int task = threadIdx.x + (k0 + k) * NC;
      const int b = b0 + task / CH, j = n0 + (task % CH) * 8;
      if (task >= BM * CH || b >= p.B || j >= H) continue;
      const int n = min(8, H - j);
      const size_t o = (size_t)b * H + j, x0 = (size_t)b * h3 + j;
      if (carry) load8f<TMA>(p.dh + o, n, dv[k]);
      dsv[k] = load8<TMA>(p.ds + o, n);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        xs[k][g] = load8<TMA>(p.xp + x0 + g * H, n);
        hs[k][g] = load8<TMA>(p.hp + x0 + g * H, n);
      }
      if (p.h_prev != nullptr) hv[k] = load8<TMA>(p.h_prev + o, n);
      else hv[k].u = make_uint4(0, 0, 0, 0);
      if (p.mask != nullptr)
#pragma unroll
        for (int g = 0; g < 3; ++g)
          ms[k][g] = load8<TMA>(p.mask + g * p.gstride + o, n);
    }
#pragma unroll
    for (int k = 0; k < KB && k0 + k < PER; ++k) {
      const int task = threadIdx.x + (k0 + k) * NC;
      const int r = task / CH, c0 = (task % CH) * 8;
      const int b = b0 + r, j = n0 + c0;
      if (task >= BM * CH || b >= p.B || j >= H) continue;
      const int n = min(8, H - j);
      const size_t o = (size_t)b * H + j, x0 = (size_t)b * h3 + j;
      float d[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) d[e] = carry ? dv[k][e] : 0.0f;
      if (carry) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const float4* c4 =
              reinterpret_cast<const float4*>(cs + (g * BM + r) * LDC + c0);
          const float4 lo = c4[0], hi = c4[1];
          const float v[8] = {lo.x, lo.y, lo.z, lo.w,
                              hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float m = p.mask != nullptr ? f32(lane8(ms[k][g], e))
                                              : 1.0f;
            d[e] = __fmaf_rn(v[e], m, d[e]);
          }
        }
      }
      Pack8 ox[3], oh[3];
      float carry_out[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float hn = f32(lane8(hs[k][2], e));
        const float gg = f32(lane8(dsv[k], e)) + d[e];
        const float rg = sigmoid(f32(lane8(xs[k][0], e)) +
                                 f32(lane8(hs[k][0], e)));
        const float z = sigmoid(f32(lane8(xs[k][1], e)) +
                                f32(lane8(hs[k][1], e)));
        const float nn = tanhf(f32(lane8(xs[k][2], e)) + rg * hn);
        const float dn = gg * (1.0f - z);
        const float dsz = gg * (f32(lane8(hv[k], e)) - nn) * z * (1.0f - z);
        const float dsn = dn * (1.0f - nn * nn);
        const float dhn = dsn * rg;
        const float dsr = dsn * hn * rg * (1.0f - rg);
        set_lane8(ox[0], e, rn(dsr));
        set_lane8(ox[1], e, rn(dsz));
        set_lane8(ox[2], e, rn(dsn));
        set_lane8(oh[0], e, rn(dsr));
        set_lane8(oh[1], e, rn(dsz));
        set_lane8(oh[2], e, rn(dhn));
        carry_out[e] = gg * z;
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        store8<TMA>(p.dxp + x0 + g * H, ox[g], n);
        store8<TMA>(p.dhp + x0 + g * H, oh[g], n);
      }
      store8f<TMA>(p.dh + o, carry_out, n);
    }
  }
}

// Reverse timestep s.  tmA: dh_proj (T, B, 3H) as dims (H, 3, B, T), boxes
// (BK, 1, BM, 1), 64B-swizzled; tmW: W_hh (3H, H) as dims (16, H, 3,
// H / 16) (units within a chunk, depth rows, gates, 16-unit chunks),
// boxes (16, BK, 1, BN / 16), 32B-swizzled.  Unused when TMA is false.
template <int WG, int BN, bool TMA>
__global__ void __launch_bounds__(BwdTile<WG, BN>::NT, 1)
gru_bwd_step_kernel(const __grid_constant__ CUtensorMap tmA,
                    const __grid_constant__ CUtensorMap tmW,
                    const BwdStep p) {
  using Tl = BwdTile<WG, BN>;
  constexpr int BM = Tl::BM, BK = Tl::BK;
  extern __shared__ unsigned char bdyn[];
  // the swizzled tiles need 1024-byte aligned shared addresses
  unsigned char* ring = bdyn + ((1024 - (smem_u32(bdyn) & 1023)) & 1023);
  const int S = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Tl::RING(S));
  uint64_t* empty = full + S;
  const int n0 = blockIdx.x * BN;
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
    if (p.dhp_next == nullptr) return;
    for (int kt = 0; kt < p.nk; ++kt) {
      const int s = kt % S;
      if (kt >= S) mbar_wait(empty + s, ((kt / S) + 1) & 1);
      unsigned char* st = ring + (size_t)s * Tl::STAGE;
      const int j0 = kt * BK;
      if constexpr (TMA) {
        if (lane == 0) {
          mbar_arrive_expect_tx(full + s, Tl::STAGE);
#pragma unroll
          for (int g = 0; g < 3; ++g)
            tma_load_4d(st + g * Tl::A_BYTES, &tmA, full + s, j0, g, b0,
                        p.a_t);
#pragma unroll
          for (int g = 0; g < 3; ++g)
            tma_load_4d(st + 3 * Tl::A_BYTES + g * Tl::W_BYTES, &tmW,
                        full + s, 0, j0, g, n0 / 16);
        }
      } else {
        const size_t h3 = (size_t)3 * p.H;
        for (int i = lane; i < 3 * BM * BK; i += 32) {
          const int g = i / (BM * BK), r = (i / BK) % BM, c = i % BK;
          const int b = b0 + r, j = j0 + c;
          const bf16 v = b < p.B && j < p.H
                             ? p.dhp_next[(size_t)b * h3 + g * p.H + j]
                             : bf16_zero();
          *reinterpret_cast<bf16*>(st + g * Tl::A_BYTES +
                                   swizzled<64>(r, c)) = v;
        }
        for (int i = lane; i < 3 * BK * BN; i += 32) {
          const int g = i / (BK * BN), c = (i / BN) % BK, u = i % BN;
          const int j = j0 + c, k = n0 + u;
          const bf16 v = j < p.H && k < p.H
                             ? p.w[((size_t)g * p.H + j) * p.H + k]
                             : bf16_zero();
          *reinterpret_cast<bf16*>(st + 3 * Tl::A_BYTES + g * Tl::W_BYTES +
                                   (u / 16) * Tl::W_CHUNK +
                                   swizzled<32>(c, u % 16)) = v;
        }
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + s);
      }
    }
    return;
  }
  bwd_consume<WG, BN, TMA>(p, ring, full, empty, n0, b0);
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

// The backward's instances, (WG = BM / 64, BN, TMA), mirrored by
// ops/cuda/gru_kernel.BWD_TILES (the TMA ones) and BWD_RAGGED_TILE.
#define VQACX_BWD_TILES(X) \
  X(2, 80, true)           \
  X(1, 48, true)           \
  X(1, 48, false)

template <int WG, int BN, bool TMA>
cudaError_t bwd_launch(const CUtensorMap& tmA, const CUtensorMap& tmW,
                       BwdStep p, int T, const bf16* xp,
                       const bf16* states, const bf16* hproj,
                       const bf16* ds, bf16* dxp, bf16* dhp,
                       cudaStream_t s) {
  using Tl = BwdTile<WG, BN>;
  auto kernel = gru_bwd_step_kernel<WG, BN, TMA>;
  const size_t smem = 1024 + Tl::RING(p.stages) + 16 * p.stages;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.H + BN - 1) / BN, (p.B + Tl::BM - 1) / Tl::BM);
  const size_t step_h = (size_t)p.B * p.H, step_x = 3 * step_h;
  for (int t = T - 1; t >= 0; --t) {
    p.dhp_next = t < T - 1 ? dhp + (t + 1) * step_x : nullptr;
    p.a_t = t + 1;
    p.ds = ds + t * step_h;
    p.xp = xp + t * step_x;
    p.hp = hproj + t * step_x;
    p.h_prev = t > 0 ? states + (t - 1) * step_h : nullptr;
    p.dxp = dxp + t * step_x;
    p.dhp = dhp + t * step_x;
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
// mask_gates as for the forward.  The tile (bm, bn, tma) must be one of
// VQACX_BWD_TILES'; TMA needs H % 16 == 0; ``stages`` deep ring.
extern "C" int vqacx_gru_bwd(const void* xp, const void* w, const void* mask,
                             int mask_gates, const void* states,
                             const void* hproj, const void* dstates,
                             void* dxp, void* dhproj, void* dh, int T, int B,
                             int H, int bm, int bn, int tma, int stages,
                             void* stream) {
  using namespace vqacx;
  if (mask_gates != 0 && mask_gates != 1 && mask_gates != 3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T <= 0 || B <= 0 || H <= 0 || stages < 2 || (tma && H % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdStep p{};
  p.w = static_cast<const bf16*>(w);
  p.mask = mask_gates > 0 ? static_cast<const bf16*>(mask) : nullptr;
  p.gstride = mask_gates == 3 ? (size_t)B * H : 0;
  p.dh = static_cast<float*>(dh);
  p.B = B;
  p.H = H;
  p.nk = (H + 31) / 32;
  p.stages = stages;
  bf16* dhp_ = static_cast<bf16*>(dhproj);
  CUtensorMap tmA{}, tmW{};
  if (tma) {
    const uint64_t h = (uint64_t)H;
    // dh_proj (T, B, 3H) as (H, 3, B, T): a gate's K runs end at H (zeros
    // past it, not the next gate's columns)
    const uint64_t adims[4] = {h, 3, (uint64_t)B, (uint64_t)T};
    const uint64_t astrides[3] = {2 * h, 6 * h, 6 * h * B};
    const uint32_t abox[4] = {32, 1, (uint32_t)bm, 1};
    // W_hh (3H, H) as (16, H, 3, H / 16): a box is BK depth rows of
    // bn / 16 chunks of 16 units, each chunk's rows 32 bytes apart
    const uint64_t wdims[4] = {16, h, 3, h / 16};
    const uint64_t wstrides[3] = {2 * h, 2 * h * h, 32};
    const uint32_t wbox[4] = {16, 32, 1, (uint32_t)bn / 16};
    if (!bf16_tensor_map_strided(&tmA, dhp_, 4, adims, astrides, abox, 64) ||
        !bf16_tensor_map_strided(&tmW, w, 4, wdims, wstrides, wbox, 32))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xp_ = static_cast<const bf16*>(xp);
  const bf16* states_ = static_cast<const bf16*>(states);
  const bf16* hproj_ = static_cast<const bf16*>(hproj);
  const bf16* ds_ = static_cast<const bf16*>(dstates);
  bf16* dxp_ = static_cast<bf16*>(dxp);
#define VQACX_BWD_CASE(WG_, BN_, TMA_)                                     \
  if (bm == 64 * WG_ && bn == BN_ && (tma != 0) == TMA_)                   \
    return static_cast<int>(bwd_launch<WG_, BN_, TMA_>(                    \
        tmA, tmW, p, T, xp_, states_, hproj_, ds_, dxp_, dhp_, s));
  VQACX_BWD_TILES(VQACX_BWD_CASE)
#undef VQACX_BWD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
