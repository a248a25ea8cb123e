// Pieces of the tensor-core flash kernels shared by flash_attention.cu
// (the forward and dQ) and flash_pack2.cu (the packed-heads forward), on
// the building blocks of hopper.cuh.
//
// The blocks of those kernels have one shape: one producer warp TMA-loads
// the block's fixed tiles once (the q tile; in dQ also the dO tile) and
// then streams (k tile, v tile) pairs of 64 keys through a ring of kStages
// stages guarded by full/empty mbarriers; two consumer warpgroups each own
// 64 q rows of one head and walk the ring. The flash forward gives its
// warpgroups the two 64-row halves of a 128-row q tile of one head; the
// packed forward gives them the two heads of a pair, each a 64-column
// panel of the same 64 rows. fwd_consumer is the forward's loop for
// either: the online softmax on the S = Q K^T accumulators, P rounded to
// bf16 in registers as the A operand of O += P V.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace flash_tc {

constexpr int kStages = 2;          // tiles in flight per ring
constexpr int kWarpgroups = 2;      // consumer warpgroups of a ring block
constexpr int kRingThreads = kWarpgroups * 128 + 32;   // + the producer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Shared memory of a forward block: the q tile (kRows rows of W columns),
// then kStages (k tile, v tile) pairs of 64 rows, then the barriers (q,
// full[kStages], empty[kStages]); each tile W / 64 panels of [rows][64].
template <int W, int kRows>
struct FwdSmem {
  static constexpr uint32_t kQ = kRows * W * 2;
  static constexpr uint32_t kT = 64 * W * 2;
  static constexpr uint32_t kBars = kQ + kStages * 2 * kT;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
};

// Thread 0 initialises the fixed tiles' barrier and the ring's: a full
// barrier completes on the producer's arrival and its bytes, an empty one
// on one arrival per consumer warp.
__device__ __forceinline__ void ring_init(uint64_t* fixed, uint64_t* full,
                                          uint64_t* empty) {
  using namespace hopper;
  if (threadIdx.x == 0) {
    mbar_init(fixed, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarpgroups * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The W / 64 panels of the [kRows, W] tile at row `row` of slab `bh`
// into dst (panel p at dst + p * kRows * 128), completing on `bar`.
template <int W, int kRows>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
#pragma unroll
  for (int p = 0; p < W / 64; ++p)
    hopper::tma_load_3d(dst + p * kRows * 128, map, bar, p * 64, row, bh);
}

// The producer's stream, run by one thread: k and v tiles 0 .. n - 1 of
// slab `bh` (64 rows of W columns each) into the ring at `ring`, stage s
// holding the k tile at ring + 2 s kT and the v tile kT after it.
template <int W>
__device__ __forceinline__ void stream_kv(uint8_t* ring,
                                          const CUtensorMap* tk,
                                          const CUtensorMap* tv,
                                          uint64_t* full, uint64_t* empty,
                                          int n, int bh) {
  using namespace hopper;
  constexpr uint32_t kT = 64 * W * 2;
  for (int t = 0; t < n; ++t) {
    const int s = t % kStages;
    if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
    uint8_t* kt = ring + s * 2 * kT;
    mbar_expect_tx(&full[s], 2 * kT);
    tma_tile<W, 64>(kt, tk, &full[s], t * 64, bh);
    tma_tile<W, 64>(kt + kT, tv, &full[s], t * 64, bh);
  }
}

// One consumer warpgroup of a forward block: q rows row0 .. row0 + 63 of
// one head (this thread rows r_lo and r_lo + 8, columns 8 j + cq, + 1 of
// every 8-column chunk j) against the first nk of the block's nk_block
// ring tiles; the tiles past nk (rows this warpgroup does not need, or
// owns none of) are still waited for and released, so the ring's phases
// stay in step with the other warpgroup's. D is the head width: q rows at
// q_base, its panels q_panel bytes apart; the head's k tile of stage s at
// kv + s * stage_bytes (its panels 64 x 128 bytes apart), its v tile
// v_off after it. O (bf16) goes to o[row * ld + col] for row < Sq, and,
// if lse is not null, lse = m + log(l) (natural log, f32) to lse[row].
template <int D>
__device__ __forceinline__ void fwd_consumer(
    uint32_t q_base, uint32_t q_panel, uint8_t* kv, uint32_t stage_bytes,
    uint32_t v_off, uint64_t* qbar, uint64_t* full, uint64_t* empty,
    int nk_block, int nk, int row0, int Sq, int Sk, bool causal,
    float scale_log2, __nv_bfloat16* __restrict__ o, int ld,
    float* __restrict__ lse) {
  using namespace hopper;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int r_lo = row0 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};   // row max of S * scale * log2(e)
  float l[2] = {0.0f, 0.0f};             // this thread's part of the row sum
  mbar_wait(qbar, 0);

  for (int t = 0; t < nk_block; ++t) {
    const int s = t % kStages;
    const uint32_t k_base = smem_u32(kv + s * stage_bytes);
    const uint32_t v_base = k_base + v_off;
    mbar_wait(&full[s], (t / kStages) & 1);
    if (t < nk) {   // uniform over the warpgroup
      float sc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss(sc, desc(q_base + (kk / 4) * q_panel + (kk % 4) * 32, 16, 1024),
               desc(k_base + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
               kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);

      const int k0 = t * 64;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int h = (r >> 1) & 1;
        const int col = k0 + 8 * (r >> 2) + cq + (r & 1);
        if (col >= Sk || (causal && col > r_lo + 8 * h)) sc[r] = -INFINITY;
        mx[h] = fmaxf(mx[h], sc[r]);
      }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        // every row sees key 0 in tile 0, so m is finite from there on
        const float m_new = fmaxf(m[h], mx[h] * scale_log2);
        alpha[h] = exp2_approx(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
      uint32_t pa[16];   // P as the A operand: 4 registers per 16 keys
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int h = (r >> 1) & 1;
        const float p0 = exp2_approx(fmaf(sc[r], scale_log2, -m[h]));
        const float p1 = exp2_approx(fmaf(sc[r + 1], scale_log2, -m[h]));
        l[h] += p0 + p1;
        pa[r / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(acc, &pa[4 * kk], desc(v_base + kk * 16 * 128, 64 * 128, 1024));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (nk == 0) return;

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
#pragma unroll
  for (int r = 0; r < D / 2; r += 2) {
    const int h = (r >> 1) & 1;
    const int row = r_lo + 8 * h;
    if (row < Sq) {
      __nv_bfloat16* dst = o + size_t(row) * ld + 8 * (r >> 2) + cq;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[r] * inv[h], acc[r + 1] * inv[h]);
    }
  }
  if (lse != nullptr && lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r_lo + 8 * h;
      if (row < Sq) lse[row] = m[h] * kLn2 + logf(l[h]);
    }
  }
}

}  // namespace flash_tc
