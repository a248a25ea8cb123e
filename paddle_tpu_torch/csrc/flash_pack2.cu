// Packed-heads flash-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/flash_pack2_bench.py:
//   flash_pack2_fwd_kernel <- _packed_fwd_kernel (pallas_call in
//                             packed_flash_fwd, :114)
// Same function on head-pair slabs q/k/v [bh/2, s, 2d] (f32 or bf16, each
// slab row the two heads of a pair side by side, d <= 64 per head): O, in the
// input dtype, is each half's own attention, softmax(scale q_h k_h^T) v_h
// with causal masking on request, and no lse. The TPU kernel fills its
// 128-lane matrix unit by multiplying a [bq, 2d] q tile with block-diagonal
// [2bk, 2d] K/V tiles, half of whose products are zeros, and segments the
// online softmax per head. Here nothing needs padding to 128 lanes, so the
// block-diagonal zeros are never formed or multiplied: one block per (head
// pair, 64-row q tile) walks the k tiles once and runs, for each tile, the
// two heads' score products, online-softmax steps and P·V products on the
// tiles of flash_tiles.cuh, with the per-head state (m, l, acc) for both
// halves in registers.
//
// Bound: the same as flash_fwd's without the lse (at b 8, h 16, s 1024,
// d 64, bf16, causal: 67 MB of q, k, v and o, 17 GFLOP of causal products,
// ~0.02 ms on the H100), and like flash_fwd this first version runs its
// products in f32 on the CUDA cores. Shared memory holds both heads' q and k
// tiles but one V tile and one P tile, reloaded for the second head, which
// keeps a block at 103 KB (d 64) so that two blocks fit on an SM.

#include "flash_tiles.cuh"

namespace {

constexpr int kMaxD = 64;   // per head: the pair's slab row is 2d wide

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
    flash_pack2_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int Sq, int Sk, int D, float scale, bool causal) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [2][D][kLd], pre-scaled
  float* kt = qt + 2 * D * kLd;                  // [2][D][kLd]
  float* vn = kt + 2 * D * kLd;                  // [kB][D], one head's V
  float* pt = vn + kB * D;                       // [kB][kLd] P transposed

  const int ld = 2 * D;
  const int pair = static_cast<int>(blockIdx.x);
  const int q0 = (static_cast<int>(gridDim.y) - 1 -
                  static_cast<int>(blockIdx.y)) * kB;   // heavy tiles first
  const int ty = static_cast<int>(threadIdx.x) / 16;
  const int tx = static_cast<int>(threadIdx.x) % 16;
  const T* qb = q + size_t(pair) * Sq * ld;
  const T* kb = k + size_t(pair) * Sk * ld;
  const T* vb = v + size_t(pair) * Sk * ld;

#pragma unroll
  for (int h = 0; h < 2; ++h)
    load_t(qt + h * D * kLd, qb + h * D, q0, Sq, D, ld, scale);
  float m[2][4], l[2][4], acc[2][4][NJ];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[h][i] = -INFINITY;
      l[h][i] = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[h][i][j] = 0.0f;
    }
  const int nk = k_tiles(q0, Sk, causal);
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kB;
    __syncthreads();   // the previous tile's kt, vn, pt are no longer read
#pragma unroll
    for (int h = 0; h < 2; ++h)
      load_t(kt + h * D * kLd, kb + h * D, k0, Sk, D, ld, 1.0f);
    load_n(vn, vb, k0, Sk, D, ld, 1.0f);
    __syncthreads();
    float s[2][4][4] = {};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tile_dot(s[h], qt + h * D * kLd, kt + h * D * kLd, D, ty, tx);
      online_softmax<NJ>(s[h], m[h], l[h], acc[h], q0, k0, Sk, causal, ty,
                         tx);
    }
    store_t(pt, s[0], ty, tx);
    __syncthreads();
    tile_acc<NJ>(acc[0], pt, vn, D, ty, tx);
    __syncthreads();   // the first head's P and V are no longer read
    store_t(pt, s[1], ty, tx);
    load_n(vn, vb + D, k0, Sk, D, ld, 1.0f);
    __syncthreads();
    tile_acc<NJ>(acc[1], pt, vn, D, ty, tx);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row >= Sq) continue;
      const float inv = 1.0f / l[h][i];
      T* orow = o + (size_t(pair) * Sq + row) * ld + h * D;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < D) store(&orow[c], acc[h][i][j] * inv);
      }
    }
}

size_t fwd_smem(int D) {
  return (4 * size_t(D) * kLd + size_t(kB) * D + size_t(kB) * kLd) *
         sizeof(float);
}

template <typename T, int NJ>
int fwd(const void* q, const void* k, const void* v, void* o, int BH2,
        int Sq, int Sk, int D, float scale, bool causal, cudaStream_t st) {
  const size_t smem = fwd_smem(D);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      flash_pack2_fwd_kernel<T, NJ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc != 0) return rc;
  dim3 grid(BH2, (Sq + kB - 1) / kB);
  flash_pack2_fwd_kernel<T, NJ><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, D, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and o share it). D is the
// per-head width; each slab row holds 2 D values. Returns cudaGetLastError()
// after the launch, or -1 for arguments it does not take.
extern "C" int flash_pack2_fwd_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH2,
                                      int Sq, int Sk, int D, float scale,
                                      int causal, int dtype, void* stream) {
  if (BH2 < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
      (causal && Sq != Sk) || (Sq + kB - 1) / kB > 65535)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D <= 32) return fwd<float, 2>(q, k, v, o, BH2, Sq, Sk, D, scale,
                                      causal != 0, st);
    return fwd<float, 4>(q, k, v, o, BH2, Sq, Sk, D, scale, causal != 0, st);
  }
  if (dtype == 1) {
    if (D <= 32) return fwd<__nv_bfloat16, 2>(q, k, v, o, BH2, Sq, Sk, D,
                                              scale, causal != 0, st);
    return fwd<__nv_bfloat16, 4>(q, k, v, o, BH2, Sq, Sk, D, scale,
                                 causal != 0, st);
  }
  return -1;
}

extern "C" const char* flash_pack2_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
