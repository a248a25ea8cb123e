// Tile helpers shared by the flash-attention kernels (flash_attention.cu,
// flash_pack2.cu): 64-row tiles of a [S, ld] slab staged in shared memory as
// f32, a 256-thread block as a 16 x 16 grid where thread (ty, tx) owns a
// 4 x 4 patch of each 64 x 64 score tile (rows ty*4.., cols tx*4..) and, of
// each [64, D] output tile, rows ty*4.. and columns tx + 16 j; operands of a
// score product transposed ([D][64], row stride kLd = 68 so float4 reads stay
// aligned and bank conflicts stay low), operands of an output product in
// natural [64][D] layout; the online softmax with its per-row state in
// registers, reduced with shuffles inside a half warp.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kLd = kB + 4;     // row stride of a transposed [d][64] tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// Rows [row0, row0 + 64) of the first D columns of a [S, ld] slab times
// `mul`, as a transposed tile t[c * kLd + r]; rows >= S are zero.
template <typename T>
__device__ __forceinline__ void load_t(float* t, const T* src, int row0,
                                       int S, int D, int ld, float mul) {
  for (int i = static_cast<int>(threadIdx.x); i < kB * D; i += kThreads) {
    const int r = i / D;
    const int c = i - r * D;
    const int row = row0 + r;
    t[c * kLd + r] = row < S ? to_f32(src[size_t(row) * ld + c]) * mul : 0.0f;
  }
}

// The same rows of a contiguous [S, D] slab (ld == D) in natural layout
// n[r * D + c]: one run of 64 * D elements, addressed without the row split
// of the strided form below, which made flash_fwd_kernel 11% slower on an
// H100 (paddle_tpu_torch/tools/kernel_ab.py).
template <typename T>
__device__ __forceinline__ void load_n(float* n, const T* src, int row0,
                                       int S, int D, float mul) {
  for (int i = static_cast<int>(threadIdx.x); i < kB * D; i += kThreads) {
    const int row = row0 + i / D;
    n[i] = row < S ? to_f32(src[size_t(row0) * D + i]) * mul : 0.0f;
  }
}

// The same rows of the first D columns of a [S, ld] slab in natural layout.
template <typename T>
__device__ __forceinline__ void load_n(float* n, const T* src, int row0,
                                       int S, int D, int ld, float mul) {
  for (int i = static_cast<int>(threadIdx.x); i < kB * D; i += kThreads) {
    const int r = i / D;
    const int row = row0 + r;
    n[i] = row < S ? to_f32(src[size_t(row) * ld + (i - r * D)]) * mul
                   : 0.0f;
  }
}

// acc[i][j] += sum_c at[c][ty*4 + i] * bt[c][tx*4 + j]
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* at,
                                         const float* bt, int D, int ty,
                                         int tx) {
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(at + c * kLd + ty * 4);
    const float4 b = *reinterpret_cast<const float4*>(bt + c * kLd + tx * 4);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r pt[r][ty*4 + i] * n[r][tx + 16 j] over the 64 rows r of
// a transposed probability tile and a natural [64, D] operand tile.
template <int NJ>
__device__ __forceinline__ void tile_acc(float (&acc)[4][NJ], const float* pt,
                                         const float* n, int D, int ty,
                                         int tx) {
#pragma unroll 2
  for (int r = 0; r < kB; ++r) {
    const float4 p = *reinterpret_cast<const float4*>(pt + r * kLd + ty * 4);
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      const float v = c < D ? n[r * D + c] : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], v, acc[i][j]);
    }
  }
}

// Store s[i][j] of thread (ty, tx) transposed: pt[(tx*4 + j) * kLd + ty*4 + i].
__device__ __forceinline__ void store_t(float* pt, const float (&s)[4][4],
                                        int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(pt + (tx * 4 + j) * kLd + ty * 4) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// Reductions over the 16 threads of a row group (one half warp).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// k tiles a q tile starting at q0 reads: up to its last row when causal.
__device__ __forceinline__ int k_tiles(int q0, int Sk, bool causal) {
  const int n = (Sk + kB - 1) / kB;
  return causal ? min(n, (q0 + kB - 1) / kB + 1) : n;
}

// One k tile's step of the online softmax for the 4 rows of thread (ty, tx):
// the scores s of q rows q0 + ty*4 + i against keys k0 + tx*4 + j (keys past
// Sk, and above the diagonal when causal, masked to -inf) become
// exp(s - m_new); l and acc are rescaled to the new row maxima m.
template <int NJ>
__device__ __forceinline__ void online_softmax(float (&s)[4][4],
                                               float (&m)[4], float (&l)[4],
                                               float (&acc)[4][NJ], int q0,
                                               int k0, int Sk, bool causal,
                                               int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      if (col >= Sk || (causal && col > row)) s[i][j] = -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
    // every row sees key 0 in tile 0, so m_new is finite from there on
    const float m_new = fmaxf(m[i], group_max(mx));
    const float alpha = expf(m[i] - m_new);
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = expf(s[i][j] - m_new);
      rs += s[i][j];
    }
    l[i] = l[i] * alpha + group_sum(rs);
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
  }
}

}  // namespace

