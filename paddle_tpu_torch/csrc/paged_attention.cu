// Paged attention over the block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py:_kernel
// (launched by paged_attention, pallas_call at :188). Same function:
// query row i of batch row b sits at absolute position pos[b] + i and
// attends every key j <= pos[b] + i, walking the row's block table
// tables[b, :] over the pool [num_blocks, heads, block_size, head_dim];
// int8 pools are dequantized as codes * (scale / 127), bit-equal to
// ops/attention_ops.py:block_gather_dequant.
//
// Bound: memory. Each valid K/V row is read once (per query tile) and
// used for 2*d FLOPs per query row. At the serving decode shape (b 8,
// h 16, d 64, pos ~200, f32 pools) one call reads ~13 MB, ~4 us at
// 3.35 TB/s; its FLOPs (~0.1 GFLOP) are far below the f32 rate.
//
// Design (simple and correct first): one thread block of kRows = 8
// warps per (b, h, tile of up to 8 query rows). A tile of `rows` rows
// gives each row 8 / rows warps (decode: all 8 on its one row), and
// the warps of a row take its keys round-robin within each table entry;
// warps left over (8 % rows) only help stage tiles. The block loops
// over the table entries its rows can see
// (t < ceil((pos + last_row + 1) / bs)); entries past that — trash
// padding included — are never read. Each entry's K and V [bs, d] are
// staged in shared memory as f32 (upcast from bf16, dequantized from
// int8) by all 256 threads. Each warp keeps its query row and output
// accumulator in registers (lanes stride over d, so any d <= 256 works
// without padding), takes lane-split dot products reduced with
// shuffles, and runs the online softmax (running max m, normalizer l)
// over its keys; at the end the warps of a row merge their (m, l, acc)
// through shared memory. Key 0 is valid for every row (pos >= 0) and
// always falls to the row's first warp, so the merged normalizer is
// > 0, also for prefill padding rows whose table is all trash. No
// wgmma, TMA or load/compute overlap yet: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRows = 8;          // query rows (warps) per block, max
constexpr int kMaxD = 256;
constexpr int kPerLane = kMaxD / kWarp;
constexpr float kQmax = 127.0f;   // ops/quant_ops.py KV_QMAX

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename QT, typename KT, bool kQuant>
__global__ void paged_attention_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int32_t* __restrict__ tables,
    const int32_t* __restrict__ pos, QT* __restrict__ out, int H, int S,
    int D, int NB, int BS, int T, int rows, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                       // [BS, D]
  float* vs = ks + BS * D;                // [BS, D]
  float* part_acc = vs + BS * D;          // [kRows, D] per-warp partials
  float* part_m = part_acc + kRows * D;   // [kRows]
  float* part_l = part_m + kRows;         // [kRows]

  const int bh = static_cast<int>(blockIdx.x);
  const int tile = static_cast<int>(blockIdx.y);
  const int b = bh / H;
  const int h = bh % H;
  const int warp = static_cast<int>(threadIdx.x) / kWarp;
  const int lane = static_cast<int>(threadIdx.x) % kWarp;
  const int splits = kRows / rows;   // warps sharing one query row
  const int r = warp / splits;        // the warp's row within the tile
  const int part = warp % splits;     // it takes keys j = part mod splits
  const int row = tile * rows + r;
  const bool active = r < rows && row < S;
  const int p = pos[b];
  const int last_row = min(S, (tile + 1) * rows) - 1;
  const int nt = min(T, (p + last_row + BS) / BS);   // ceil((p+last+1)/BS)
  const int qpos = p + row;

  float qr[kPerLane];
  float acc[kPerLane];
  const size_t qoff = ((size_t(b) * H + h) * S + row) * D;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const int c = lane + j * kWarp;
    qr[j] = (active && c < D) ? to_f32(q[qoff + c]) * scale : 0.0f;
    acc[j] = 0.0f;
  }
  float m = -INFINITY;
  float l = 0.0f;

  for (int t = 0; t < nt; ++t) {
    const int blk = tables[size_t(b) * T + t];
    if (blk < 0 || blk >= NB) __trap();   // a bad table must not read wild
    const size_t base = (size_t(blk) * H + h) * size_t(BS) * D;
    float kmul = 1.0f, vmul = 1.0f;
    if (kQuant) {
      kmul = k_scale[size_t(blk) * H + h] / kQmax;
      vmul = v_scale[size_t(blk) * H + h] / kQmax;
    }
    __syncthreads();   // every warp is done with the previous tile
#pragma unroll 4
    for (int i = static_cast<int>(threadIdx.x); i < BS * D;
         i += static_cast<int>(blockDim.x)) {
      float kv = to_f32(k_pool[base + i]);
      float vv = to_f32(v_pool[base + i]);
      if (kQuant) {
        kv *= kmul;
        vv *= vmul;
      }
      ks[i] = kv;
      vs[i] = vv;
    }
    __syncthreads();
    if (!active) continue;
    const int kmax = min(BS, qpos - t * BS + 1);   // keys <= qpos here
    for (int j = part; j < kmax; j += splits) {
      float dot = 0.0f;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int c = lane + e * kWarp;
        if (c < D) dot += qr[e] * ks[j * D + c];
      }
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const float m_new = fmaxf(m, dot);
      const float alpha = expf(m - m_new);
      const float pj = expf(dot - m_new);
      l = l * alpha + pj;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) {
        const int c = lane + e * kWarp;
        if (c < D) acc[e] = acc[e] * alpha + pj * vs[j * D + c];
      }
      m = m_new;
    }
  }
  // merge the partial softmax states of the warps sharing a row
  if (active) {
    if (lane == 0) {
      part_m[warp] = m;
      part_l[warp] = l;
    }
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = lane + e * kWarp;
      if (c < D) part_acc[warp * D + c] = acc[e];
    }
  }
  __syncthreads();
  if (!active || part != 0) return;
  float mx = -INFINITY;
  for (int w = warp; w < warp + splits; ++w) mx = fmaxf(mx, part_m[w]);
  float lsum = 0.0f;
  float o[kPerLane];
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) o[e] = 0.0f;
  for (int w = warp; w < warp + splits; ++w) {
    const float f = expf(part_m[w] - mx);   // 0 for a warp that saw no key
    lsum += part_l[w] * f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int c = lane + e * kWarp;
      if (c < D) o[e] += part_acc[w * D + c] * f;
    }
  }
  const float inv = 1.0f / lsum;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int c = lane + e * kWarp;
    if (c < D) store(&out[qoff + c], o[e] * inv);
  }
}

template <typename QT, typename KT, bool kQuant>
void launch(const void* q, const void* k, const void* v, const void* ks,
            const void* vs, const void* tables, const void* pos, void* out,
            int B, int H, int S, int D, int NB, int BS, int T, float scale,
            cudaStream_t stream) {
  const int rows = S < kRows ? S : kRows;
  dim3 grid(B * H, (S + rows - 1) / rows);
  dim3 block(kRows * kWarp);
  const size_t smem =
      (2 * size_t(BS) * D + size_t(kRows) * D + 2 * kRows) * sizeof(float);
  paged_attention_kernel<QT, KT, kQuant><<<grid, block, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(pos), static_cast<QT*>(out), H, S, D, NB,
      BS, T, rows, scale);
}

template <typename QT>
int dispatch_kv(int kv_dtype, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, const void* tables,
                const void* pos, void* out, int B, int H, int S, int D,
                int NB, int BS, int T, float scale, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      launch<QT, float, false>(q, k, v, ks, vs, tables, pos, out, B, H, S,
                               D, NB, BS, T, scale, stream);
      return 0;
    case 1:
      launch<QT, __nv_bfloat16, false>(q, k, v, ks, vs, tables, pos, out,
                                       B, H, S, D, NB, BS, T, scale,
                                       stream);
      return 0;
    case 2:
      launch<QT, int8_t, true>(q, k, v, ks, vs, tables, pos, out, B, H, S,
                               D, NB, BS, T, scale, stream);
      return 0;
  }
  return -1;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (KV only; needs the
// [NB, H] float32 scales). Returns cudaGetLastError() after the launch,
// or -1 for a dtype code it does not take.
extern "C" int paged_attention_launch(const void* q, const void* k,
                                      const void* v, const void* k_scale,
                                      const void* v_scale,
                                      const void* tables, const void* pos,
                                      void* out, int B, int H, int S, int D,
                                      int NB, int BS, int T, float scale,
                                      int q_dtype, int kv_dtype,
                                      void* stream) {
  if (D < 1 || D > kMaxD || S < 1 || BS < 1 || T < 1) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == 0) {
    rc = dispatch_kv<float>(kv_dtype, q, k, v, k_scale, v_scale, tables, pos,
                            out, B, H, S, D, NB, BS, T, scale, st);
  } else if (q_dtype == 1) {
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale,
                                    tables, pos, out, B, H, S, D, NB, BS, T,
                                    scale, st);
  } else {
    rc = -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* paged_attention_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
