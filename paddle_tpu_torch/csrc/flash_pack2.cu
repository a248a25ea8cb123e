// Packed-heads flash-attention forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/flash_pack2_bench.py:
//   flash_pack2_fwd_wgmma_kernel, flash_pack2_fwd_kernel
//     <- _packed_fwd_kernel (pallas_call in packed_flash_fwd, :114)
// Same function on head-pair slabs q/k/v [bh/2, s, 2d] (f32 or bf16, each
// slab row the two heads of a pair side by side, d <= 64 per head): O, in the
// input dtype, is each half's own attention, softmax(scale q_h k_h^T) v_h
// with causal masking on request, and no lse. The TPU kernel fills its
// 128-lane matrix unit by multiplying a [bq, 2d] q tile with block-diagonal
// [2bk, 2d] K/V tiles, half of whose products are zeros, and segments the
// online softmax per head. Here nothing needs padding to 128 lanes, so the
// block-diagonal zeros are never formed or multiplied.
//
// Bound: the same as flash_fwd's without the lse (at b 8, h 16, s 1024,
// d 64, bf16, causal: 67 MB of q, k, v and o, 17 GFLOP of causal products,
// ~0.02 ms on the H100), product-bound once the products run on the tensor
// cores.
//
// bf16 with d 64 (the probe's shape) takes the tensor-core kernel: a slab
// row of a pair is 128 bf16 values, two 64-column panels, so a tensor map
// {128, s, bh/2} with 64-column boxes loads head h as panel h of each tile,
// the layout of the d = 128 flash forward. One block per (head pair,
// 64-row q tile): the producer warp loads the q tile once and streams the
// (k, v) tiles of both heads through the ring, and consumer warpgroup h
// runs the flash forward's loop (flash_tc.cuh's fwd_consumer) on panel h,
// writing O at column 64 h of rows 128 values long. Both warpgroups walk
// the same causal range. f32 and other widths keep the first version,
// flash_pack2_fwd_kernel, below: one block per (head pair, 64-row q tile)
// walks the k tiles once and runs, for each tile, the two heads' score
// products, online-softmax steps and P.V products in f32 on the CUDA
// cores (the tiles of flash_tiles.cuh), with the per-head state (m, l,
// acc) for both halves in registers. Its shared memory holds both heads'
// q and k tiles but one V tile and one P tile, reloaded for the second
// head, which keeps a block at 103 KB (d 64) so that two blocks fit on
// an SM.

#include "flash_tc.cuh"
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

bool tc_route(int dtype, int D) { return dtype == 1 && D == 64; }

constexpr int kMapError = -2;
using PackSmem = flash_tc::FwdSmem<128, 64>;   // 82,984 B of dynamic smem

__global__ void __launch_bounds__(flash_tc::kRingThreads, 1)
    flash_pack2_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 __nv_bfloat16* __restrict__ o, int Sq,
                                 int Sk, float scale_log2, bool causal) {
  using namespace flash_tc;
  using L = PackSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align_1024(smem_raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + kStages;

  const int pair = static_cast<int>(blockIdx.x);
  const int q0 = (static_cast<int>(gridDim.y) - 1 -
                  static_cast<int>(blockIdx.y)) * 64;   // heavy tiles first
  const int n_k = (Sk + 63) / 64;
  const int nk = causal ? min(n_k, q0 / 64 + 1) : n_k;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  ring_init(qbar, full, empty);

  if (warp == kWarpgroups * 4) {   // the producer warp: lane 0 copies
    if (threadIdx.x % 32 == 0) {
      hopper::mbar_expect_tx(qbar, L::kQ);
      tma_tile<128, 64>(sm, &tq, qbar, q0, pair);
      stream_kv<128>(sm + L::kQ, &tk, &tv, full, empty, nk, pair);
    }
    return;
  }
  const int h = warp / 4;   // the warpgroup's head: panel h of every tile
  fwd_consumer<64>(hopper::smem_u32(sm) + h * 64 * 128, 0,
                   sm + L::kQ + h * 64 * 128, 2 * L::kT, L::kT, qbar, full,
                   empty, nk, nk, q0, Sq, Sk, causal, scale_log2,
                   o + size_t(pair) * Sq * 128 + h * 64, 128, nullptr);
}

int fwd_tc(const void* q, const void* k, const void* v, void* o, int BH2,
           int Sq, int Sk, float scale, bool causal, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  if (!hopper::slab_map(&mq, q, BH2, Sq, 128, 64) ||
      !hopper::slab_map(&mk, k, BH2, Sk, 128, 64) ||
      !hopper::slab_map(&mv, v, BH2, Sk, 128, 64))
    return kMapError;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      flash_pack2_fwd_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(PackSmem::kBytes)));
  if (rc != 0) return rc;
  dim3 grid(BH2, (Sq + 63) / 64);
  flash_pack2_fwd_wgmma_kernel<<<grid, flash_tc::kRingThreads,
                                 PackSmem::kBytes, st>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), Sq, Sk,
      scale * flash_tc::kLog2e, causal);
  return static_cast<int>(cudaGetLastError());
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
// after the launch, -1 for arguments it does not take, or -2 when
// cuTensorMapEncodeTiled refuses a tensor map. The launch takes the
// tensor-core kernel where flash_pack2_tc_route says so.
extern "C" int flash_pack2_tc_route(int dtype, int D) {
  return tc_route(dtype, D) ? 1 : 0;
}

extern "C" int flash_pack2_fwd_launch(const void* q, const void* k,
                                      const void* v, void* o, int BH2,
                                      int Sq, int Sk, int D, float scale,
                                      int causal, int dtype, void* stream) {
  if (BH2 < 1 || Sq < 1 || Sk < 1 || D < 1 || D > kMaxD ||
      (causal && Sq != Sk) || (Sq + kB - 1) / kB > 65535)
    return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_route(dtype, D))
    return fwd_tc(q, k, v, o, BH2, Sq, Sk, scale, causal != 0, st);
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
  if (code == kMapError)
    return "TMA tensor map refused (a pointer not 16-byte aligned?)";
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
