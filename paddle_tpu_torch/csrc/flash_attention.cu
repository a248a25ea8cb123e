// Flash attention forward and backward, for Hopper (sm_90a).
//
// Replaces the three TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel     (pallas_call in _flash_fwd, :83)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel  (pallas_call in _flash_bwd, :189)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (pallas_call in _flash_bwd, :206)
// Same functions on q/k/v [bh, s, d] (f32 or bf16, accumulation f32):
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
// and the bytes (3.35 TB/s) each cost ~0.02-0.035 ms. This first version
// runs its products on the CUDA cores in f32 (FMA, 67 TFLOP/s peak), so it is
// bound by FMA issue and shared-memory reads: ~19 TFLOP/s, 43-52x above the
// bound on an H100 80GB HBM3 at 700 W (chip_smoke.py phase 8); moving the
// products of each tile to mma/wgmma is the next step.
//
// Design (simple and correct first): one block of 256 threads per (bh,
// 64-row tile), on the tiles of flash_tiles.cuh: each thread owns a 4 x 4
// patch of every 64 x 64 score tile and columns tx + 16 j of every output
// row it holds, so any d <= 128 works without the reference's lane padding
// (pad_lane_dim). The per-row softmax state (m, l) lives in registers,
// replicated over the 16 threads of a row group.
// Rows and keys past the sequence end (a ragged last tile: the caller admits
// any multiple of 16) are loaded as zeros and masked: keys to -inf in the
// forward and dQ, q rows to lse = +inf (P = 0) in dK/dV. The backward needs
// no atomics: dQ is gridded over q tiles, dK/dV over k tiles. The blocks with
// the most causal work are launched first.

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
    return -1;                                                          \
  } while (0)

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs
// share it; lse and delta are float32 [BH, Sq]). Each returns
// cudaGetLastError() after its launch, or -1 for arguments it does not take.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* o, void* lse, int BH, int Sq, int Sk,
                                int D, float scale, int causal, int dtype,
                                void* stream) {
  if (bad_shape(BH, Sq, Sk, D, causal)) return -1;
  FLASH_DISPATCH(fwd, q, k, v, o, lse, BH, Sq, Sk, D, scale, causal != 0,
                 static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_out, int BH, int Sq, int Sk,
                                   int D, float scale, int causal, int dtype,
                                   void* stream) {
  if (bad_shape(BH, Sq, Sk, D, causal)) return -1;
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, BH, Sq, Sk, D, scale,
                 causal != 0, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk_out, void* dv_out, int BH,
                                    int Sq, int Sk, int D, float scale,
                                    int causal, int dtype, void* stream) {
  if (bad_shape(BH, Sq, Sk, D, causal)) return -1;
  FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dk_out, dv_out, BH, Sq, Sk,
                 D, scale, causal != 0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
