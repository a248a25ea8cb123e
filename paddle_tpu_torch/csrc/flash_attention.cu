// Flash attention forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel     (pallas_call in _flash_fwd, :83)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel  (pallas_call in _flash_bwd, :189)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (pallas_call in _flash_bwd, :206)
// Same functions on q/k/v [bh, s, d] (f32, bf16 or fp16, accumulation f32):
// the forward emits O in the input dtype and lse = m + log(l) in f32
// [bh, s_q]; the backward takes lse and delta = sum(dO * O, -1) (computed
// outside, as the JAX package does at :186) and recomputes P = exp(S - lse)
// tile by tile, so nothing of size s x s reaches device memory. Causal
// attention skips the tiles above the diagonal: a q tile walks k tiles up to
// its last row, a k tile walks q tiles from its first row.
//
// Bound: at the training shape (b 8, h 16, s 1024, d 64, bf16, causal) the
// three calls do about 17, 26 and 34 GFLOP against 68, 85 and 102 MB of
// compulsory traffic: on the H100's tensor cores (989 TFLOP/s bf16) the work
// and the bytes (3.35 TB/s) each cost ~0.02-0.035 ms. For bf16 with d 64 or
// 128 all three run on the tensor cores (flash_fwd_wgmma_kernel,
// flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel, designed below);
// every f32 or other-width call runs the first version, which does its
// products on the CUDA cores in f32 (FMA, 67 TFLOP/s peak): bound by the
// FMA rate and shared-memory reads at ~19 TFLOP/s, 43-52x above the bound
// on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 8).
//
// Design of the first version (simple and correct first): one block of 256
// threads per (bh, 64-row tile), on the tiles of flash_tiles.cuh: each
// thread owns a 4 x 4
// patch of every 64 x 64 score tile and columns tx + 16 j of every output
// row it holds, so any d <= 128 works without the reference's lane padding
// (pad_lane_dim). The per-row softmax state (m, l) lives in registers,
// replicated over the 16 threads of a row group.
// Rows and keys past the sequence end (a ragged last tile: the caller admits
// any multiple of 16) are loaded as zeros and masked: keys to -inf in the
// forward and dQ, q rows to lse = +inf (P = 0) in dK/dV. The backward needs
// no atomics: dQ is gridded over q tiles, dK/dV over k tiles. The blocks with
// the most causal work are launched first.

#include "flash_tc.cuh"
#include "flash_tiles.cuh"

namespace {

constexpr int kMaxD = 128;

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int D,
                     float scale, bool causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLd], pre-scaled
  float* kt = qt + D * kLd;                      // [D][kLd]
  float* vn = kt + D * kLd;                      // [kB][D]
  float* pt = vn + kB * D;                       // [kB][kLd] P transposed

  const int bh = static_cast<int>(blockIdx.x);
  const int q0 = (static_cast<int>(gridDim.y) - 1 -
                  static_cast<int>(blockIdx.y)) * kB;   // heavy tiles first
  const int ty = static_cast<int>(threadIdx.x) / 16;
  const int tx = static_cast<int>(threadIdx.x) % 16;
  const T* qb = q + size_t(bh) * Sq * D;
  const T* kb = k + size_t(bh) * Sk * D;
  const T* vb = v + size_t(bh) * Sk * D;

  load_t(qt, qb, q0, Sq, D, D, scale);
  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }
  const int nk = k_tiles(q0, Sk, causal);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kB;
    __syncthreads();   // the previous tile's kt, vn, pt are no longer read
    load_t(kt, kb, k0, Sk, D, D, 1.0f);
    load_n(vn, vb, k0, Sk, D, 1.0f);
    __syncthreads();
    float s[4][4] = {};
    tile_dot(s, qt, kt, D, ty, tx);
    online_softmax<NJ>(s, m, l, acc, q0, k0, Sk, causal, ty, tx);
    store_t(pt, s, ty, tx);
    __syncthreads();
    tile_acc<NJ>(acc, pt, vn, D, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = 1.0f / l[i];
    T* orow = o + (size_t(bh) * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(&orow[c], acc[i][j] * inv);
    }
    if (tx == 0) lse[size_t(bh) * Sq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int D, float scale, bool causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLd], pre-scaled
  float* dot = qt + D * kLd;                     // [D][kLd] dO transposed
  float* kt = dot + D * kLd;                     // [D][kLd]
  float* vt = kt + D * kLd;                      // [D][kLd]
  float* kn = vt + D * kLd;                      // [kB][D]
  float* dst = kn + kB * D;                      // [kB][kLd] dS transposed

  const int bh = static_cast<int>(blockIdx.x);
  const int q0 = (static_cast<int>(gridDim.y) - 1 -
                  static_cast<int>(blockIdx.y)) * kB;
  const int ty = static_cast<int>(threadIdx.x) / 16;
  const int tx = static_cast<int>(threadIdx.x) % 16;
  const T* kb = k + size_t(bh) * Sk * D;
  const T* vb = v + size_t(bh) * Sk * D;

  load_t(qt, q + size_t(bh) * Sq * D, q0, Sq, D, D, scale);
  load_t(dot, dout + size_t(bh) * Sq * D, q0, Sq, D, D, 1.0f);
  // rows past Sq compute finite garbage that is never stored
  float lr[4], dr[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lr[i] = row < Sq ? lse[size_t(bh) * Sq + row] : 0.0f;
    dr[i] = row < Sq ? delta[size_t(bh) * Sq + row] : 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }
  const int nk = k_tiles(q0, Sk, causal);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kB;
    __syncthreads();
    load_t(kt, kb, k0, Sk, D, D, 1.0f);
    load_t(vt, vb, k0, Sk, D, D, 1.0f);
    load_n(kn, kb, k0, Sk, D, 1.0f);
    __syncthreads();
    float s[4][4] = {};
    float dp[4][4] = {};
    tile_dot(s, qt, kt, D, ty, tx);
    tile_dot(dp, dot, vt, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool dead = col >= Sk || (causal && col > row);
        const float p = dead ? 0.0f : expf(s[i][j] - lr[i]);
        s[i][j] = p * (dp[i][j] - dr[i]);
      }
    }
    store_t(dst, s, ty, tx);
    __syncthreads();
    tile_acc<NJ>(acc, dst, kn, D, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    T* out = dq + (size_t(bh) * Sq + row) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(&out[c], acc[i][j] * scale);
    }
  }
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, int Sq, int Sk, int D,
                         float scale, bool causal) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][kLd]
  float* vt = kt + D * kLd;                      // [D][kLd]
  float* qa = vt + D * kLd;     // q tile (pre-scaled): [D][kLd], then [kB][D]
  float* da = qa + D * kLd;     // dO tile: [D][kLd], then [kB][D]
  float* ps = da + D * kLd;     // [kB q][kLd] P^T stored q-major
  float* dss = ps + kB * kLd;   // [kB q][kLd] dS^T stored q-major
  float* lse_s = dss + kB * kLd;   // [kB]
  float* delta_s = lse_s + kB;     // [kB]

  const int bh = static_cast<int>(blockIdx.x);
  const int k0 = static_cast<int>(blockIdx.y) * kB;   // heavy tiles first
  const int ty = static_cast<int>(threadIdx.x) / 16;
  const int tx = static_cast<int>(threadIdx.x) % 16;
  const T* qb = q + size_t(bh) * Sq * D;
  const T* db = dout + size_t(bh) * Sq * D;
  const float* lb = lse + size_t(bh) * Sq;
  const float* deb = delta + size_t(bh) * Sq;

  load_t(kt, k + size_t(bh) * Sk * D, k0, Sk, D, D, 1.0f);
  load_t(vt, v + size_t(bh) * Sk * D, k0, Sk, D, D, 1.0f);
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk_acc[i][j] = 0.0f;
      dv_acc[i][j] = 0.0f;
    }
  const int nq = (Sq + kB - 1) / kB;
  for (int t = causal ? k0 / kB : 0; t < nq; ++t) {
    const int q0 = t * kB;
    __syncthreads();   // the previous q tile's buffers are no longer read
    load_t(qa, qb, q0, Sq, D, D, scale);
    load_t(da, db, q0, Sq, D, D, 1.0f);
    for (int r = static_cast<int>(threadIdx.x); r < kB; r += kThreads) {
      const bool live = q0 + r < Sq;
      lse_s[r] = live ? lb[q0 + r] : INFINITY;   // P = 0 for padding rows
      delta_s[r] = live ? deb[q0 + r] : 0.0f;
    }
    __syncthreads();
    // transposed tiles: rows are keys (ty*4 + i), columns queries (tx*4 + j)
    float p[4][4] = {};
    float ds[4][4] = {};
    tile_dot(p, kt, qa, D, ty, tx);
    tile_dot(ds, vt, da, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx * 4 + j;
        const bool dead = causal && key > q0 + qr;
        p[i][j] = dead ? 0.0f : expf(p[i][j] - lse_s[qr]);
        ds[i][j] = p[i][j] * (ds[i][j] - delta_s[qr]);
      }
    }
    __syncthreads();   // done with the transposed q and dO tiles
    load_n(qa, qb, q0, Sq, D, scale);
    load_n(da, db, q0, Sq, D, 1.0f);
    store_t(ps, p, ty, tx);
    store_t(dss, ds, ty, tx);
    __syncthreads();
    tile_acc<NJ>(dv_acc, ps, da, D, ty, tx);
    tile_acc<NJ>(dk_acc, dss, qa, D, ty, tx);
  }
  // q was pre-scaled, so dk already carries the scale
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= Sk) continue;
    T* dkr = dk + (size_t(bh) * Sk + key) * D;
    T* dvr = dv + (size_t(bh) * Sk + key) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        store(&dkr[c], dk_acc[i][j]);
        store(&dvr[c], dv_acc[i][j]);
      }
    }
  }
}

size_t fwd_smem(int D) {
  return (2 * size_t(D) * kLd + size_t(kB) * D + size_t(kB) * kLd) *
         sizeof(float);
}
size_t dq_smem(int D) {
  return (4 * size_t(D) * kLd + size_t(kB) * D + size_t(kB) * kLd) *
         sizeof(float);
}
size_t dkv_smem(int D) {
  return (4 * size_t(D) * kLd + 2 * size_t(kB) * kLd + 2 * kB) *
         sizeof(float);
}

template <typename K>
int prepare(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <typename T, int NJ>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int BH, int Sq, int Sk, int D, float scale, bool causal,
        cudaStream_t st) {
  const size_t smem = fwd_smem(D);
  int rc = prepare(flash_fwd_kernel<T, NJ>, smem);
  if (rc != 0) return rc;
  dim3 grid(BH, (Sq + kB - 1) / kB);
  flash_fwd_kernel<T, NJ><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int dq(const void* q, const void* k, const void* v, const void* dout,
       const void* lse, const void* delta, void* dqp, int BH, int Sq, int Sk,
       int D, float scale, bool causal, cudaStream_t st) {
  const size_t smem = dq_smem(D);
  int rc = prepare(flash_bwd_dq_kernel<T, NJ>, smem);
  if (rc != 0) return rc;
  dim3 grid(BH, (Sq + kB - 1) / kB);
  flash_bwd_dq_kernel<T, NJ><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dqp), Sq, Sk, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NJ>
int dkv(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dkp, void* dvp, int BH,
        int Sq, int Sk, int D, float scale, bool causal, cudaStream_t st) {
  const size_t smem = dkv_smem(D);
  int rc = prepare(flash_bwd_dkv_kernel<T, NJ>, smem);
  if (rc != 0) return rc;
  dim3 grid(BH, (Sk + kB - 1) / kB);
  flash_bwd_dkv_kernel<T, NJ><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dkp), static_cast<T*>(dvp), Sq, Sk, D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------- tensor-core route (sm_90a)
//
// bf16 q/k/v/dO with d 64 or 128 (every GPT config of models/gpt.py) run
// on the tensor cores; f32 and other widths keep the CUDA-core kernels
// above. Bound at the training shape (b 8, h 16, s 1024, d 64, causal):
// forward 17.2 GFLOP in 0.017 ms at 989 TFLOP/s against 0.020 ms for its
// bytes, dQ 25.8 GFLOP in 0.026 ms, dK/dV 34.4 GFLOP in 0.035 ms; all are
// product-bound once the products run in wgmma, so the design keeps the
// tensor cores fed:
// - tiles arrive by TMA into 128-byte-swizzled shared memory that wgmma
//   reads directly (hopper.cuh), issued by one producer warp into a ring
//   of kStages stages guarded by full/empty mbarriers, so the next tile is
//   in flight while this one is multiplied (the forward's and dQ's ring
//   and the forward's loop live in flash_tc.cuh, shared with the packed
//   forward of flash_pack2.cu);
// - the first products of a step (S = Q K^T, in dQ also dP = dO V^T; in
//   dK/dV S^T = K Q^T and dP^T = V dO^T) are SS wgmmas with f32
//   accumulators in registers;
// - the softmax runs on the accumulator fragment (a row lives in the 4
//   threads of a quad: shuffles with xor 1, 2), with scale * log2(e)
//   folded into exp2;
// - P (and dS) are rounded to bf16 in registers and feed the second
//   product (O += P V; dQ += dS K; dV += P^T dO, dK += dS^T Q) as its
//   register A operand: no probability tile touches shared memory. That
//   rounding is the route's one numerical difference from the f32
//   kernels, as in every FlashAttention (chip_smoke.py holds it to a
//   stated bound).
// Masks are as above: keys past Sk or above the diagonal to -inf in the
// forward (P = 0 in dQ); q rows past Sq to lse = +inf (P = 0) in dQ and
// dK/dV. dQ walks the k tiles of its own 128 q rows and dK/dV the q tiles
// of its own 64 keys, so neither needs atomics.

using flash_tc::kLn2;
using flash_tc::kLog2e;
using flash_tc::kStages;
constexpr int kFwdRows = 64 * flash_tc::kWarpgroups;   // q rows per block
constexpr int kMapError = -2;

bool tc_route(int dtype, int D) { return dtype == 1 && (D == 64 || D == 128); }

// The forward's block: the producer warp loads the 128-row q tile and
// streams the k and v tiles; consumer warpgroup wg owns q rows
// q0 + 64 wg .. + 63 (flash_tc.cuh). Dynamic shared memory: 50,216 B at
// d 64, 99,368 B at d 128.
template <int D>
__global__ void __launch_bounds__(flash_tc::kRingThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Sk,
                           float scale_log2, bool causal) {
  using namespace flash_tc;
  using L = FwdSmem<D, kFwdRows>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int bh = static_cast<int>(blockIdx.x);
  const int q0 = (static_cast<int>(gridDim.y) - 1 -
                  static_cast<int>(blockIdx.y)) * kFwdRows;   // heavy first
  const int n_k = (Sk + 63) / 64;
  const int nk_block = causal ? min(n_k, (q0 + kFwdRows - 1) / 64 + 1) : n_k;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  ring_init(qbar, full, empty);

  if (warp == kWarpgroups * 4) {   // the producer warp: lane 0 copies
    if (threadIdx.x % 32 == 0) {
      hopper::mbar_expect_tx(qbar, L::kQ);
      tma_tile<D, kFwdRows>(sm, &tq, qbar, q0, bh);
      stream_kv<D>(sm + L::kQ, &tk, &tv, full, empty, nk_block, bh);
    }
    return;
  }
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64;
  const int nk = row0 >= Sq ? 0
                 : causal   ? min(n_k, (row0 + 63) / 64 + 1)
                            : n_k;
  fwd_consumer<D>(hopper::smem_u32(sm) + wg * 64 * 128, kFwdRows * 128,
                  sm + L::kQ, 2 * L::kT, L::kT, qbar, full, empty, nk_block,
                  nk, row0, Sq, Sk, causal, scale_log2,
                  o + size_t(bh) * Sq * D, D, lse + size_t(bh) * Sq);
}

// Shared memory of dQ: the q and dO tiles (128 rows each), then kStages
// (k tile, v tile) pairs, then the barriers. Dynamic: 66,600 B at d 64,
// 132,136 B at d 128.
template <int D>
struct DqSmem {
  static constexpr uint32_t kQ = kFwdRows * D * 2;
  static constexpr uint32_t kT = 64 * D * 2;
  static constexpr uint32_t kBars = 2 * kQ + kStages * 2 * kT;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
};

// dQ on the tensor cores: the forward's block with dO beside q. Per k
// tile, S = Q K^T and dP = dO V^T as SS wgmmas (V read K-major, like K),
// P = exp2(S scale log2(e) - lse log2(e)) with keys past Sk and above the
// diagonal at 0, dS = P (dP - delta) rounded to bf16 in registers as the A
// operand of dQ += dS K (K read MN-major, like V in the forward). Each
// block owns its q rows, so no atomics; q rows past Sq read lse = +inf
// (P = 0) and are never stored.
template <int D>
__global__ void __launch_bounds__(flash_tc::kRingThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                              float scale, bool causal) {
  using namespace flash_tc;
  using namespace hopper;
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int bh = static_cast<int>(blockIdx.x);
  const int q0 = (static_cast<int>(gridDim.y) - 1 -
                  static_cast<int>(blockIdx.y)) * kFwdRows;   // heavy first
  const int n_k = (Sk + 63) / 64;
  const int nk_block = causal ? min(n_k, (q0 + kFwdRows - 1) / 64 + 1) : n_k;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  ring_init(qbar, full, empty);

  if (warp == kWarpgroups * 4) {   // the producer warp: lane 0 copies
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * L::kQ);
      tma_tile<D, kFwdRows>(sm, &tq, qbar, q0, bh);
      tma_tile<D, kFwdRows>(sm + L::kQ, &tdo, qbar, q0, bh);
      stream_kv<D>(sm + 2 * L::kQ, &tk, &tv, full, empty, nk_block, bh);
    }
    return;
  }

  // consumer warpgroup wg owns q rows row0 .. row0 + 63; this thread rows
  // r_lo and r_lo + 8, columns 8 j + cq, + 1 of every 8-column chunk j
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64;
  const int nk = row0 >= Sq ? 0
                 : causal   ? min(n_k, (row0 + 63) / 64 + 1)
                            : n_k;
  const int r_lo = row0 + (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_base = smem_u32(sm) + wg * 64 * 128;
  const uint32_t do_base = q_base + L::kQ;
  float lse2[2], dl[2];   // this thread's rows: lse * log2(e), delta
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r_lo + 8 * h;
    const bool live = row < Sq;
    lse2[h] = live ? lse[size_t(bh) * Sq + row] * kLog2e : INFINITY;
    dl[h] = live ? delta[size_t(bh) * Sq + row] : 0.0f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  mbar_wait(qbar, 0);

  for (int t = 0; t < nk_block; ++t) {
    const int s = t % kStages;
    const uint32_t k_base = smem_u32(sm + 2 * L::kQ + s * 2 * L::kT);
    const uint32_t v_base = k_base + L::kT;
    mbar_wait(&full[s], (t / kStages) & 1);
    if (t < nk) {   // uniform over the warpgroup
      float sp[32], dp[32];   // S, then P; dP
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss(sp,
               desc(q_base + (kk / 4) * kFwdRows * 128 + (kk % 4) * 32, 16,
                    1024),
               desc(k_base + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
               kk > 0);
      wg_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_ss(dp,
               desc(do_base + (kk / 4) * kFwdRows * 128 + (kk % 4) * 32, 16,
                    1024),
               desc(v_base + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
               kk > 0);
      wg_commit();
      wg_wait<1>();   // S is in; dP may still be on its way
      fence_regs(sp);
      const int k0 = t * 64;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int h = (r >> 1) & 1;
        const int col = k0 + 8 * (r >> 2) + cq + (r & 1);
        const float p = exp2_approx(fmaf(sp[r], scale_log2, -lse2[h]));
        sp[r] = col >= Sk || (causal && col > r_lo + 8 * h) ? 0.0f : p;
      }
      wg_wait<0>();
      fence_regs(dp);
      uint32_t da[16];   // dS as the A operand: 4 registers per 16 keys
#pragma unroll
      for (int r = 0; r < 32; r += 2) {
        const int h = (r >> 1) & 1;
        da[r / 2] = pack_bf16(sp[r] * (dp[r] - dl[h]),
                              sp[r + 1] * (dp[r + 1] - dl[h]));
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_rs(acc, &da[4 * kk], desc(k_base + kk * 16 * 128, 64 * 128, 1024));
      wg_commit();
      wg_wait<0>();
      fence_regs(acc);
      fence_regs(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if (nk == 0) return;

#pragma unroll
  for (int r = 0; r < D / 2; r += 2) {
    const int row = r_lo + 8 * ((r >> 1) & 1);
    if (row < Sq) {
      __nv_bfloat16* dst = dq + (size_t(bh) * Sq + row) * D + 8 * (r >> 2) + cq;
      *reinterpret_cast<__nv_bfloat162*>(dst) =
          __floats2bfloat162_rn(acc[r] * scale, acc[r + 1] * scale);
    }
  }
}

// Shared memory of dK/dV: the k and v tiles, then kStages (q tile, dO
// tile) pairs, then kStages (lse * log2(e), delta) slices of 64 f32 each,
// then the barriers. Dynamic: 51,240 B at d 64, 100,392 B at d 128.
template <int D>
struct DkvSmem {
  static constexpr uint32_t kT = 64 * D * 2;
  static constexpr uint32_t kStats = 2 * kT + kStages * 2 * kT;
  static constexpr uint32_t kBars = kStats + kStages * 2 * 64 * 4;
  static constexpr size_t kBytes = 1024 + kBars + 8 * (1 + 2 * kStages);
};

template <int D>
__global__ void __launch_bounds__(160, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               __nv_bfloat16* __restrict__ dk,
                               __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                               float scale, bool causal) {
  using namespace hopper;
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = flash_tc::align_1024(smem_raw);
  float* stats = reinterpret_cast<float*>(sm + L::kStats);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + kStages;

  const int bh = static_cast<int>(blockIdx.x);
  const int k0 = static_cast<int>(blockIdx.y) * 64;   // heavy tiles first
  const int t0 = causal ? k0 / 64 : 0;                 // first q tile
  const int n = (Sq + 63) / 64 - t0;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int lane = static_cast<int>(threadIdx.x) % 32;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {   // the producer warp
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * L::kT);
      for (int p = 0; p < D / 64; ++p) {
        tma_load_3d(sm + p * 64 * 128, &tk, kvbar, p * 64, k0, bh);
        tma_load_3d(sm + L::kT + p * 64 * 128, &tv, kvbar, p * 64, k0, bh);
      }
    }
    const float* lb = lse + size_t(bh) * Sq;
    const float* db = delta + size_t(bh) * Sq;
    for (int i = 0; i < n; ++i) {
      const int s = i % kStages;
      const int q0 = (t0 + i) * 64;
      if (i >= kStages) mbar_wait(&empty[s], (i / kStages - 1) & 1);
      float* st = stats + s * 128;
      for (int r = lane; r < 64; r += 32) {
        const bool live = q0 + r < Sq;   // P = 0 for rows past the end
        st[r] = live ? lb[q0 + r] * kLog2e : INFINITY;
        st[64 + r] = live ? db[q0 + r] : 0.0f;
      }
      __syncwarp();   // the slices are written before lane 0 arrives
      if (lane == 0) {
        uint8_t* qt = sm + 2 * L::kT + s * 2 * L::kT;
        mbar_expect_tx(&full[s], 2 * L::kT);
        for (int p = 0; p < D / 64; ++p) {
          tma_load_3d(qt + p * 64 * 128, &tq, &full[s], p * 64, q0, bh);
          tma_load_3d(qt + L::kT + p * 64 * 128, &tdo, &full[s], p * 64, q0,
                      bh);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds keys key_lo and key_lo + 8
  // and, of each product over q, the columns 8 j + cq, + 1
  const int key_lo = k0 + warp * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_base = smem_u32(sm);
  const uint32_t v_base = k_base + L::kT;
  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    adk[i] = 0.0f;
    adv[i] = 0.0f;
  }
  mbar_wait(kvbar, 0);

  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    const int q0 = (t0 + i) * 64;
    const uint32_t q_base = smem_u32(sm + 2 * L::kT + s * 2 * L::kT);
    const uint32_t do_base = q_base + L::kT;
    const float* st = stats + s * 128;
    mbar_wait(&full[s], (i / kStages) & 1);

    float sp[32], dp[32];   // S^T, then P^T; dP^T, then dS^T
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(sp, desc(k_base + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
             desc(q_base + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
             kk > 0);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss(dp, desc(v_base + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
             desc(do_base + (kk / 4) * 64 * 128 + (kk % 4) * 32, 16, 1024),
             kk > 0);
    wg_commit();
    wg_wait<1>();   // S^T is in; dP^T may still be on its way
    fence_regs(sp);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int qi = 8 * (r >> 2) + cq + (r & 1);
      const float p = exp2_approx(fmaf(sp[r], scale_log2, -st[qi]));
      sp[r] = causal && key_lo + 8 * ((r >> 1) & 1) > q0 + qi ? 0.0f : p;
    }
    wg_wait<0>();
    fence_regs(dp);
    uint32_t pa[16], da[16];
#pragma unroll
    for (int r = 0; r < 32; r += 2) {
      const int qi = 8 * (r >> 2) + cq;
      pa[r / 2] = pack_bf16(sp[r], sp[r + 1]);
      da[r / 2] = pack_bf16(sp[r] * (dp[r] - st[64 + qi]),
                            sp[r + 1] * (dp[r + 1] - st[64 + qi + 1]));
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs(adv, &pa[4 * kk],
             desc(do_base + kk * 16 * 128, 64 * 128, 1024));
      mma_rs(adk, &da[4 * kk], desc(q_base + kk * 16 * 128, 64 * 128, 1024));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(adv);
    fence_regs(adk);
    fence_regs(pa);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int r = 0; r < D / 2; r += 2) {
    const int key = key_lo + 8 * ((r >> 1) & 1);
    if (key < Sk) {
      const size_t at = (size_t(bh) * Sk + key) * D + 8 * (r >> 2) + cq;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(adk[r] * scale, adk[r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(adv[r], adv[r + 1]);
    }
  }
}

template <int D>
int fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int Sq, int Sk, float scale, bool causal,
           cudaStream_t st) {
  using L = flash_tc::FwdSmem<D, kFwdRows>;
  CUtensorMap mq, mk, mv;
  if (!hopper::slab_map(&mq, q, BH, Sq, D, kFwdRows) ||
      !hopper::slab_map(&mk, k, BH, Sk, D, 64) ||
      !hopper::slab_map(&mv, v, BH, Sk, D, 64))
    return kMapError;
  const auto kernel = flash_fwd_wgmma_kernel<D>;
  int rc = prepare(kernel, L::kBytes);
  if (rc != 0) return rc;
  dim3 grid(BH, (Sq + kFwdRows - 1) / kFwdRows);
  kernel<<<grid, flash_tc::kRingThreads, L::kBytes, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      Sq, Sk, scale * kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_tc(const void* q, const void* k, const void* v, const void* dout,
          const void* lse, const void* delta, void* dqp, int BH, int Sq,
          int Sk, float scale, bool causal, cudaStream_t st) {
  using L = DqSmem<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::slab_map(&mq, q, BH, Sq, D, kFwdRows) ||
      !hopper::slab_map(&mk, k, BH, Sk, D, 64) ||
      !hopper::slab_map(&mv, v, BH, Sk, D, 64) ||
      !hopper::slab_map(&mdo, dout, BH, Sq, D, kFwdRows))
    return kMapError;
  const auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  int rc = prepare(kernel, L::kBytes);
  if (rc != 0) return rc;
  dim3 grid(BH, (Sq + kFwdRows - 1) / kFwdRows);
  kernel<<<grid, flash_tc::kRingThreads, L::kBytes, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dqp), Sq,
      Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv_tc(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dkp, void* dvp, int BH,
           int Sq, int Sk, float scale, bool causal, cudaStream_t st) {
  using L = DkvSmem<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper::slab_map(&mq, q, BH, Sq, D, 64) ||
      !hopper::slab_map(&mk, k, BH, Sk, D, 64) ||
      !hopper::slab_map(&mv, v, BH, Sk, D, 64) ||
      !hopper::slab_map(&mdo, dout, BH, Sq, D, 64))
    return kMapError;
  const auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  int rc = prepare(kernel, L::kBytes);
  if (rc != 0) return rc;
  dim3 grid(BH, (Sk + 63) / 64);
  kernel<<<grid, 160, L::kBytes, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dkp),
      static_cast<__nv_bfloat16*>(dvp), Sq, Sk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int BH, int Sq, int Sk, int D, int causal) {
  return BH < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
         (causal && Sq != Sk) || (Sq + kB - 1) / kB > 65535 ||
         (Sk + kB - 1) / kB > 65535;
}

// The three launches dispatch on (dtype, column chunks NJ = ceil(D / 16)
// rounded up to 2, 4 or 8).
#define FLASH_DISPATCH(FN, ...)                                         \
  do {                                                                  \
    if (dtype == 0) {                                                   \
      if (D <= 32) return FN<float, 2>(__VA_ARGS__);                    \
      if (D <= 64) return FN<float, 4>(__VA_ARGS__);                    \
      return FN<float, 8>(__VA_ARGS__);                                 \
    }                                                                   \
    if (dtype == 1) {                                                   \
      if (D <= 32) return FN<__nv_bfloat16, 2>(__VA_ARGS__);            \
      if (D <= 64) return FN<__nv_bfloat16, 4>(__VA_ARGS__);            \
      return FN<__nv_bfloat16, 8>(__VA_ARGS__);                         \
    }                                                                   \
    if (dtype == 2) {                                                   \
      if (D <= 32) return FN<__half, 2>(__VA_ARGS__);                   \
      if (D <= 64) return FN<__half, 4>(__VA_ARGS__);                   \
      return FN<__half, 8>(__VA_ARGS__);                                \
    }                                                                   \
    return -1;                                                          \
  } while (0)

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dO and
// the outputs share it; lse and delta are float32 [BH, Sq]); float16 runs
// the CUDA-core kernels only, loading fp16, computing in f32 and storing
// fp16, as the reference does. Each returns cudaGetLastError() after its
// launch, -1 for arguments it does not take, or -2 when
// cuTensorMapEncodeTiled refuses a tensor map. All three take the
// tensor-core kernels where flash_tc_route says so.
extern "C" int flash_tc_route(int dtype, int D) {
  return tc_route(dtype, D) ? 1 : 0;
}

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int Sq, int Sk,
                                int D, float scale, int causal, int dtype,
                                void* stream) {
  if (bad_shape(BH, Sq, Sk, D, causal)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_route(dtype, D))
    return D == 64 ? fwd_tc<64>(q, k, v, o, lse, BH, Sq, Sk, scale,
                                causal != 0, st)
                   : fwd_tc<128>(q, k, v, o, lse, BH, Sq, Sk, scale,
                                 causal != 0, st);
  FLASH_DISPATCH(fwd, q, k, v, o, lse, BH, Sq, Sk, D, scale, causal != 0, st);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_out, int BH, int Sq, int Sk,
                                   int D, float scale, int causal, int dtype,
                                   void* stream) {
  if (bad_shape(BH, Sq, Sk, D, causal)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_route(dtype, D))
    return D == 64 ? dq_tc<64>(q, k, v, dout, lse, delta, dq_out, BH, Sq, Sk,
                               scale, causal != 0, st)
                   : dq_tc<128>(q, k, v, dout, lse, delta, dq_out, BH, Sq,
                                Sk, scale, causal != 0, st);
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, BH, Sq, Sk, D, scale,
                 causal != 0, st);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk_out, void* dv_out, int BH,
                                    int Sq, int Sk, int D, float scale,
                                    int causal, int dtype, void* stream) {
  if (bad_shape(BH, Sq, Sk, D, causal)) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_route(dtype, D))
    return D == 64 ? dkv_tc<64>(q, k, v, dout, lse, delta, dk_out, dv_out, BH,
                                Sq, Sk, scale, causal != 0, st)
                   : dkv_tc<128>(q, k, v, dout, lse, delta, dk_out, dv_out,
                                 BH, Sq, Sk, scale, causal != 0, st);
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dk_out, dv_out, BH, Sq, Sk,
                 D, scale, causal != 0, st);
}

extern "C" const char* flash_error_string(int code) {
  if (code == kMapError)
    return "TMA tensor map refused (a pointer not 16-byte aligned?)";
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
