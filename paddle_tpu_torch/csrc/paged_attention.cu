// Paged attention over the block-paged KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py:_kernel
// (launched by paged_attention, pallas_call at :188). Same function:
// query row i of batch row b sits at absolute position pos[b] + i and
// attends every key j <= pos[b] + i, walking the row's block table
// tables[b, :] over the pool [num_blocks, heads, block_size, head_dim];
// int8 pools are dequantized as codes * (scale / 127) per element,
// bit-equal to ops/attention_ops.py:block_gather_dequant.
//
// Bound: bytes and latency. Each valid K/V row is read once per block
// of query rows and used for 2*d FLOPs per row. At the serving decode
// shape (b 8, h 16, d 64, pos ~200) one f32 call reads ~13 MB, ~4 us at
// 3.35 TB/s, and has one query row per (b, h): far too little math for
// the tensor cores, and wgmma would round q and P to bf16, which the f32
// serving path must not do. So the products stay on the CUDA cores in
// f32 and the design is about keeping bytes in flight and the chain of
// dependent steps short (pos and the table, then the K/V copies, then
// the math, then the merge): at this size the call is latency-bound.
//
// Design (ops/cuda/paged_attention.py:plan computes the launch plan and
// the shared-memory layout; this file checks them and follows them):
// - Flash-decoding split. A query tile's valid sub-tiles (entries below
//   nt = ceil((pos + last_row + 1) / bs), the tile's last row's; no
//   entry at or past it, trash padding included, is read) are cut into
//   ks contiguous, balanced ranges, one per group of warps of the block,
//   each with a private ring and a named barrier, merged through shared
//   memory at the end. With one range the warps write O from registers.
// - Sub-tiles in flight. An entry is cut into sub-tiles of kt <= 16 key
//   rows, so shared memory does not grow with block_size. A ring of 2-4
//   sub-tiles in the pool's own dtype is filled with cp.async (16-, 8-
//   or 4-byte copies, the widest that divides a key row's bytes and the
//   pools' alignment; plain element loads where none does), while the
//   group computes on the oldest stage. Rows are padded by 16 bytes in
//   shared memory so the 16 keys of a sub-tile sit in different banks.
//   Each warp keeps 32 table entries (and their int8 scales) one per
//   lane in registers, the first 32 loaded beside pos and the query
//   rows, and no copy waits on a scale.
// - Packed until the dot. bf16 and int8 stay packed in shared memory and
//   are widened in registers from 16- or 8-byte reads (int8 as
//   code * (scale / 127) per element).
// - One rescale per sub-tile. Lane j of a warp takes key j of a sub-tile
//   of kl = 16, 8 or 4 keys (the other 32 / kl - 1 lanes of key j the
//   rest of d), a row's logits reduce to one max, and the accumulator is
//   rescaled once per sub-tile, not once per key. The plan takes 8-key
//   sub-tiles where 16-key rings would not let a one-row block hold a
//   range per sub-tile (f32 at d 64).
// - Rows per block. A decode group is one warp on its one row (up to 15
//   ranges, so each warp has a sub-tile or two); wider calls give each
//   warp 8 rows (up to 8 warps, 64 rows) in one group
//   that shares every K/V sub-tile, so prefill reads each entry once per
//   64 rows. d <= 256 keeps the output accumulator in registers (lane l
//   owns columns l, l + 32, ...); wider heads take one row per warp with
//   the accumulator in shared memory.
// - Little per-warp setup. Up to 15 warps of one SM each walk a range of
//   a sub-tile or two, so at the decode shape the SM is bound by the
//   instructions it issues more than by bytes: whatever one warp
//   computes, fifteen do. A thread's copy positions (CopyPlan), the next
//   sub-tile (Unit) and its query elements are stepped, not divided
//   out; the ranges are cut in 32-bit arithmetic. The merge rescales
//   each range's accumulator in its own warp, then one thread per output
//   element adds the ranges up.
// Key 0 lies in the tile's first non-empty range and is visible to every
// row (pos >= 0), so the merged normalizer is > 0, also for prefill
// padding rows whose table is all trash at pos 0; a range that saw no
// key enters the merge with weight 0. A table entry outside [0, NB)
// traps.
//
// paged_attention_read_probe launches the same walk (pos, the table, the
// copies into the rings and their waits) with the math and the merge
// left out and writes nothing: what moving this call's bytes through
// this design costs on the card, timed beside the kernel by chip_smoke.py
// phase 5 and tools/kernel_ab.py --kernel paged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxKT = 16;        // key rows per sub-tile, at most
constexpr int kMaxStages = 4;     // sub-tiles in a shared-memory ring
constexpr int kMaxWarps = 8;      // a block of 8-row warps
constexpr int kMaxWarps1 = 16;    // a block of one-row warps
constexpr int kMaxRanges = 15;    // named barriers 1..15 (0: __syncthreads)
constexpr int kMaxSmem = 232448;  // what one block may opt in to
constexpr float kQmax = 127.0f;   // ops/quant_ops.py KV_QMAX

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int32_t* tables;
  const int32_t* pos;
  void* out;
  int H, S, D, NB, BS, T;
  int rows;           // query rows per block (row groups x rows per warp)
  int kt, nsub;       // key rows per sub-tile, sub-tiles per entry
  int stages;         // sub-tiles in each ring, 2..kMaxStages
  int tiles, ks;      // query tiles; key ranges per block
  int copy_bytes;     // 16, 8, 4, or 0 = element loads
  // the plan's shared-memory layout, in bytes from the start: ks rings
  // of `stages` stages of `stage` bytes at 0 (each K and V sub-tile of
  // kt rows `rs` apart, then the int8 multipliers), reused for the ks
  // groups' partial accumulators once every group is done; the tile's
  // query rows (`dp` floats each) at q_off; the groups' partial (m, l)
  // at ml_off; the accumulators of d > 256 at acc_off
  int rs, stage, dp, q_off, ml_off, acc_off;
  int q_bf16;
  float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(N));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for all but the newest stages - 1 commit groups.
__device__ __forceinline__ void cp_wait_stages(int stages) {
  if (stages == 2)
    cp_wait<1>();
  else if (stages == 3)
    cp_wait<2>();
  else
    cp_wait<3>();
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(int8_t x) {
  return static_cast<float>(x);
}

// 8 consecutive elements of a shared-memory key row from one vector read
// (f32: 2 x 16 B, bf16: 16 B, int8: 8 B); the row start is 16-aligned.
__device__ __forceinline__ void read8(const float* p, float (&x)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void read8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void read8(const int8_t* p, float (&x)[8]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = static_cast<float>(static_cast<int8_t>(a.x >> (8 * i)));
    x[4 + i] = static_cast<float>(static_cast<int8_t>(a.y >> (8 * i)));
  }
}

__device__ __forceinline__ float load_q(const Params& p, size_t i) {
  return p.q_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(p.q)[i])
                  : static_cast<const float*>(p.q)[i];
}

__device__ __forceinline__ void store_out(const Params& p, size_t i,
                                          float x) {
  if (p.q_bf16)
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16(x);
  else
    static_cast<float*>(p.out)[i] = x;
}

// Group barrier: the warps of key range g (ids 1.., 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(threads) : "memory");
}

// Where a thread's copies of a sub-tile start and how they advance, in
// rows and columns of copies: the same for every sub-tile of a launch,
// so computed once per thread.
struct CopyPlan {
  int per_row;   // copies per key row
  int r, c;      // the thread's first copy
  int dr, dc;    // the step to its next one
};

__device__ __forceinline__ CopyPlan copy_plan(int row_bytes, int n, int tid,
                                              int threads) {
  CopyPlan cp;
  cp.per_row = n ? row_bytes / n : 1;
  cp.dr = threads / cp.per_row;
  cp.dc = threads - cp.dr * cp.per_row;
  cp.r = tid / cp.per_row;
  cp.c = tid - cp.r * cp.per_row;
  return cp;
}

// nk rows of K and of V from global memory (contiguous rows of row_bytes)
// to shared memory (rows rs apart), N bytes a copy.
template <int N>
__device__ __forceinline__ void copy_rows(unsigned char* kd, unsigned char* vd,
                                          const unsigned char* kg,
                                          const unsigned char* vg, int nk,
                                          int row_bytes, int rs,
                                          const CopyPlan& cp) {
  int r = cp.r;
  int c = cp.c;
  while (r < nk) {
    const int d = r * rs + c * N;
    const int g = r * row_bytes + c * N;
    cp_async<N>(kd + d, kg + g);
    cp_async<N>(vd + d, vg + g);
    r += cp.dr;
    c += cp.dc;
    if (c >= cp.per_row) {
      c -= cp.per_row;
      ++r;
    }
  }
}

// 32 consecutive table entries of one batch row, one per lane, and for
// int8 their raw scales. Loaded at the block's start (entries 0..31, in
// flight beside pos) and again where a range runs past them.
struct Window {
  int base = 0;
  int blk = 0;
  float ksc = 0.0f, vsc = 0.0f;

  template <bool kQuant>
  __device__ void load(const Params& p, int b, int h, int t0, int lane) {
    base = t0;
    const int tl = t0 + lane;
    blk = tl < p.T ? p.tables[size_t(b) * p.T + tl] : 0;
    if (kQuant) {
      const int bb = blk >= 0 && blk < p.NB ? blk : 0;   // checked at use
      ksc = p.k_scale[size_t(bb) * p.H + h];
      vsc = p.v_scale[size_t(bb) * p.H + h];
    }
  }

  // The pool block of entry t (warp-uniform); traps on a bad entry.
  template <bool kQuant>
  __device__ int block_of(const Params& p, int b, int h, int t, int lane) {
    if (t < base || t >= base + kWarp) load<kQuant>(p, b, h, t, lane);
    const int blk_t = __shfl_sync(0xffffffffu, blk, t - base);
    if (blk_t < 0 || blk_t >= p.NB) __trap();   // a bad table must not read
    return blk_t;
  }
};

// Unit u of a row's table is rows r0 = (u % nsub) * kt on of entry
// t = u / nsub; a range walks its units in order, so one division finds
// its first and each next one is a step.
struct Unit {
  int t, r0;
  __device__ Unit(const Params& p, int u) : t(u / p.nsub) {
    r0 = (u - t * p.nsub) * p.kt;
  }
  __device__ void next(const Params& p) {
    r0 += p.kt;
    if (r0 >= p.BS) {
      r0 = 0;
      ++t;
    }
  }
};

// Issue the copies of unit un of row b, head h into one ring stage.
template <typename KT>
__device__ void load_unit(const Params& p, Window& win, int b, int h,
                          const Unit& un, unsigned char* st,
                          const CopyPlan& cp, int gtid, int gthreads) {
  constexpr bool kQuant = sizeof(KT) == 1;
  const int t = un.t;
  const int r0 = un.r0;
  const int nk = min(p.kt, p.BS - r0);
  const int lane = gtid % kWarp;
  const int blk = win.block_of<kQuant>(p, b, h, t, lane);
  unsigned char* ks = st;
  unsigned char* vs = st + p.kt * p.rs;
  const size_t off = ((size_t(blk) * p.H + h) * p.BS + r0) * p.D;
  const auto* kg = reinterpret_cast<const unsigned char*>(
      static_cast<const KT*>(p.k) + off);
  const auto* vg = reinterpret_cast<const unsigned char*>(
      static_cast<const KT*>(p.v) + off);
  const int row_bytes = p.D * int(sizeof(KT));
  switch (p.copy_bytes) {
    case 16:
      copy_rows<16>(ks, vs, kg, vg, nk, row_bytes, p.rs, cp);
      break;
    case 8:
      copy_rows<8>(ks, vs, kg, vg, nk, row_bytes, p.rs, cp);
      break;
    case 4:
      copy_rows<4>(ks, vs, kg, vg, nk, row_bytes, p.rs, cp);
      break;
    default: {   // a key row's bytes are not a multiple of 4
      const int stride = p.rs / int(sizeof(KT));
      const KT* kq = reinterpret_cast<const KT*>(kg);
      const KT* vq = reinterpret_cast<const KT*>(vg);
      for (int i = gtid; i < nk * p.D; i += gthreads) {
        const int r = i / p.D;
        const int c = i - r * p.D;
        reinterpret_cast<KT*>(ks)[r * stride + c] = kq[i];
        reinterpret_cast<KT*>(vs)[r * stride + c] = vq[i];
      }
    }
  }
}

// The int8 multipliers scale / 127 of entry t, stored by the
// group's thread 0 behind the stage's V sub-tile. Called once the copies
// in flight are issued: the scale loads may still be on their way. The
// prologue's later units may have moved the window past u's entry.
__device__ __forceinline__ void store_scales(const Params& p, Window& win,
                                             int b, int h, int t,
                                             unsigned char* st, int gtid) {
  if (t < win.base || t >= win.base + kWarp)
    win.load<true>(p, b, h, t, gtid % kWarp);
  const float ksc = __shfl_sync(0xffffffffu, win.ksc, t - win.base);
  const float vsc = __shfl_sync(0xffffffffu, win.vsc, t - win.base);
  if (gtid == 0) {
    float* sc = reinterpret_cast<float*>(st + 2 * p.kt * p.rs);
    sc[0] = ksc / kQmax;
    sc[1] = vsc / kQmax;
  }
}

// Warp w is row group w % RG of key range w / RG. NE > 0: each lane
// keeps NE columns (lane + 32 e) of each of its RPW rows in registers;
// NE == 0: one row per warp, accumulator in shared memory. KT is the
// pool's element type. kMath false is the read probe: the same walk,
// no math, no merge, no output.
template <typename KT, int NE, int RPW, bool kMath>
__global__ void __launch_bounds__((RPW == 1 ? kMaxWarps1 : kMaxWarps) *
                                      kWarp,
                                  1)   // one block per SM: <= 128 registers
    paged_attention_kernel(const Params p) {
  constexpr bool kQuant = sizeof(KT) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D;
  const int RG = p.rows / RPW;                 // row groups (warps per range)
  const int sbytes = p.stage;
  const int S = p.stages;
  // the plan's layout (see Params)
  unsigned char* ring_all = smem;                     // [ks][stages]
  float* part_acc = reinterpret_cast<float*>(smem);   // [ks][rows][D]
  float* qs = reinterpret_cast<float*>(smem + p.q_off);        // [rows][dp]
  float* part_ml = reinterpret_cast<float*>(smem + p.ml_off);  // [ks][rows]
  float* acc_s = reinterpret_cast<float*>(smem + p.acc_off);   // NE == 0
  if constexpr (NE == 0) part_acc = acc_s;

  const int bh = static_cast<int>(blockIdx.x);
  const int tile = static_cast<int>(blockIdx.y);
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid / kWarp;
  const int lane = tid % kWarp;
  const int g = warp / RG;                     // the warp's key range
  const int rg = warp - g * RG;                // and row group
  const int gtid = rg * kWarp + lane;
  const int gthreads = RG * kWarp;
  const int pos_b = p.pos[b];
  Window win;
  win.load<kQuant>(p, b, h, 0, lane);          // in flight beside pos
  const int row0 = tile * p.rows;              // first row of the tile
  const int last_row = min(p.S, row0 + p.rows) - 1;
  // the tile's query rows, scaled, as f32 (zero past S and past D): the
  // first kQBatch per thread are loaded before any copy is issued and
  // stored after, the rest (rows x d > kQBatch x threads) after that. A
  // thread's elements advance by a fixed step, so no load divides.
  const size_t qbase = (size_t(bh) * p.S) * D;
  const int nthreads = static_cast<int>(blockDim.x);
  const int nq = p.rows * p.dp;
  constexpr int kQBatch = 16;
  float qv[kQBatch];
  {
    int r = tid / p.dp;
    int c = tid - r * p.dp;
    const int dr = nthreads / p.dp;
    const int dc = nthreads - dr * p.dp;
#pragma unroll
    for (int k = 0; k < kQBatch; ++k) {
      if (tid + k * nthreads >= nq) break;
      const int row = row0 + r;
      qv[k] = row < p.S && c < D ? load_q(p, qbase + size_t(row) * D + c)
                                 : 0.0f;
      r += dr;
      c += dc;
      if (c >= p.dp) {
        c -= p.dp;
        ++r;
      }
    }
  }
  const int nt = min(p.T, (pos_b + last_row + p.BS) / p.BS);
  const int U = nt * p.nsub;                   // < 2^31 / ks, checked
  const int u0 = U * g / p.ks;                 // this group's range
  const int nu = U * (g + 1) / p.ks - u0;
  const CopyPlan cp = copy_plan(p.D * int(sizeof(KT)), p.copy_bytes, gtid,
                                gthreads);
  unsigned char* ring = ring_all + size_t(g) * S * sbytes;

  Unit ld(p, u0);                              // the next unit to load
  for (int s = 0; s < S - 1; ++s) {
    if (s < nu) {
      load_unit<KT>(p, win, b, h, ld, ring + size_t(s) * sbytes, cp, gtid,
                    gthreads);
      ld.next(p);
    }
    cp_commit();
  }
  if constexpr (kQuant) {
    Unit un(p, u0);
    for (int s = 0; s < S - 1 && s < nu; ++s, un.next(p))
      store_scales(p, win, b, h, un.t, ring + size_t(s) * sbytes, gtid);
  }
#pragma unroll
  for (int k = 0; k < kQBatch; ++k) {
    const int i = tid + k * nthreads;
    if (i >= nq) break;
    qs[i] = qv[k] * p.scale;
  }
  for (int i = tid + kQBatch * nthreads; i < nq; i += nthreads) {
    const int r = i / p.dp;
    const int c = i - r * p.dp;
    const int row = row0 + r;
    qs[i] = row < p.S && c < D
                ? load_q(p, qbase + size_t(row) * D + c) * p.scale
                : 0.0f;
  }
  if constexpr (NE == 0 && kMath) {
    for (int i = tid; i < p.ks * p.rows * D;
         i += static_cast<int>(blockDim.x))
      acc_s[i] = 0.0f;
  }
  __syncthreads();

  const int wrow = rg * RPW;                   // the warp's first row
  const int nrows = max(0, min(RPW, p.S - row0 - wrow));   // active rows
  const int qlast = pos_b + row0 + wrow + nrows - 1;       // its last qpos
  float* my_acc = acc_s + (size_t(g) * p.rows + wrow) * D;  // NE == 0
  float m[RPW], l[RPW];
  float acc[RPW][NE > 0 ? NE : 1];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < (NE > 0 ? NE : 1); ++e) acc[r][e] = 0.0f;
  }

  // a sub-tile's kt <= kl keys go one to a lane; the 32 / kl lanes of a
  // key split its d into 8-wide chunks
  const int kl = p.kt > 8 ? 16 : p.kt > 4 ? 8 : 4;
  const int key = lane % kl;
  const int part = lane / kl;
  const int nparts = kWarp / kl;
  const int nchunks = (D + 7) / 8;
  const bool vec = (D % 8) == 0;
  const int stride = p.rs / int(sizeof(KT));

  Unit cu(p, u0);                              // the unit to compute
  for (int n = 0; n < nu; ++n) {
    const int nx = n + S - 1;
    if (nx < nu) {
      unsigned char* st = ring + size_t(nx % S) * sbytes;
      load_unit<KT>(p, win, b, h, ld, st, cp, gtid, gthreads);
      if constexpr (kQuant) store_scales(p, win, b, h, ld.t, st, gtid);
      ld.next(p);
    }
    cp_commit();
    cp_wait_stages(S);
    group_sync(g, gthreads);   // the group's copies of unit n have landed

    const int t = cu.t;
    const int r0 = cu.r0;
    cu.next(p);
    const int nk = min(p.kt, p.BS - r0);
    const int kpos0 = t * p.BS + r0;           // position of key row 0
    const int jmax = min(nk, qlast - kpos0 + 1);   // keys any row sees
    if (kMath && nrows > 0 && jmax > 0) {
      const unsigned char* st = ring + size_t(n % S) * sbytes;
      const KT* kst = reinterpret_cast<const KT*>(st);
      const KT* vst = reinterpret_cast<const KT*>(st + p.kt * p.rs);
      float kmul = 1.0f, vmul = 1.0f;
      if constexpr (kQuant) {
        const float* sc = reinterpret_cast<const float*>(st + 2 * p.kt * p.rs);
        kmul = sc[0];
        vmul = sc[1];
      }
      // logits: lane takes key `key`, chunks part, part + nparts, ...
      float dot[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) dot[r] = 0.0f;
      if (key < jmax) {
        const KT* krow = kst + key * stride;
#pragma unroll 4
        for (int c = part; c < nchunks; c += nparts) {
          float kx[8];
          if (vec) {
            read8(krow + c * 8, kx);
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              kx[i] = c * 8 + i < D ? widen(krow[c * 8 + i]) : 0.0f;
          }
          if constexpr (kQuant) {
#pragma unroll
            for (int i = 0; i < 8; ++i) kx[i] *= kmul;
          }
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            if (r < nrows) {
              const float* qr = qs + size_t(wrow + r) * p.dp + c * 8;
              const float4 qa = reinterpret_cast<const float4*>(qr)[0];
              const float4 qb = reinterpret_cast<const float4*>(qr)[1];
              dot[r] += qa.x * kx[0] + qa.y * kx[1] + qa.z * kx[2] +
                        qa.w * kx[3] + qb.x * kx[4] + qb.y * kx[5] +
                        qb.z * kx[6] + qb.w * kx[7];
            }
          }
        }
      }
      // one online-softmax step per row for the whole sub-tile
      float pr[RPW], alpha[RPW];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        float x = dot[r];
#pragma unroll
        for (int off = kWarp / 2; off >= 4; off >>= 1)
          if (off >= kl) x += __shfl_xor_sync(0xffffffffu, x, off);
        const int qpos = pos_b + row0 + wrow + r;
        x = (r < nrows && key < jmax && kpos0 + key <= qpos) ? x
                                                             : -INFINITY;
        float mt = x;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          if (off < kl)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m[r], mt);
        const float mu = m_new == -INFINITY ? 0.0f : m_new;
        alpha[r] = expf(m[r] - mu);
        pr[r] = expf(x - mu);
        float sum = pr[r];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          if (off < kl) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        l[r] = l[r] * alpha[r] + sum;
        m[r] = m_new;
      }
      // acc = acc * alpha + P V over the keys some row of the warp sees
      if constexpr (NE > 0) {
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int e = 0; e < NE; ++e) acc[r][e] *= alpha[r];
#pragma unroll 4
        for (int j = 0; j < jmax; ++j) {
          const KT* vrow = vst + j * stride;
          float vx[NE];
#pragma unroll
          for (int e = 0; e < NE; ++e) {
            const int c = lane + e * kWarp;
            vx[e] = c < D ? widen(vrow[c]) : 0.0f;
            if constexpr (kQuant) vx[e] *= vmul;
          }
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const float pj = __shfl_sync(0xffffffffu, pr[r], j);
#pragma unroll
            for (int e = 0; e < NE; ++e) acc[r][e] += pj * vx[e];
          }
        }
      } else {   // RPW == 1
        for (int c0 = 0; c0 < D; c0 += kWarp) {
          const int c = c0 + lane;
          float a = c < D ? my_acc[c] * alpha[0] : 0.0f;
          for (int j = 0; j < jmax; ++j) {
            const float pj = __shfl_sync(0xffffffffu, pr[0], j);
            if (c < D) {
              float vv = widen(vst[j * stride + c]);
              if constexpr (kQuant) vv *= vmul;
              a += pj * vv;
            }
          }
          if (c < D) my_acc[c] = a;
        }
      }
    }
    group_sync(g, gthreads);   // stage n is free for unit n + S
  }
  cp_wait<0>();
  if constexpr (!kMath) return;

  const size_t obase = (size_t(bh) * p.S + row0) * D;
  if (p.ks == 1) {   // one range: the warp's rows are final
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      if (r >= nrows) continue;
      const float inv = 1.0f / l[r];
      if constexpr (NE > 0) {
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const int c = lane + e * kWarp;
          if (c < D)
            store_out(p, obase + size_t(wrow + r) * D + c, acc[r][e] * inv);
        }
      } else {
        for (int c = lane; c < D; c += kWarp)
          store_out(p, obase + size_t(wrow) * D + c, my_acc[c] * inv);
      }
    }
    return;
  }

  // several ranges: each group publishes its rows' maxima; then each
  // rescales its accumulators and sums to the rows' common max and
  // stores them (the rings are free once every group is done); then one
  // thread per output element adds up the ranges
#pragma unroll
  for (int r = 0; r < RPW; ++r)
    if (r < nrows && lane == 0)
      part_ml[2 * ((size_t(g) * p.rows) + wrow + r)] = m[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    if (r >= nrows) continue;
    const int row = wrow + r;
    float mx = lane < p.ks ? part_ml[2 * (lane * p.rows + row)] : -INFINITY;
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float f = expf(m[r] - mx);   // 0 for a range that saw no key
    const size_t pr_row = size_t(g) * p.rows + row;
    if constexpr (NE > 0) {
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int c = lane + e * kWarp;
        if (c < D) part_acc[pr_row * D + c] = acc[r][e] * f;
      }
    } else {
      for (int c = lane; c < D; c += kWarp) my_acc[c] *= f;
    }
    if (lane == 0) part_ml[2 * pr_row + 1] = l[r] * f;
  }
  __syncthreads();
  const int tile_rows = min(p.rows, p.S - row0);
  for (int i = tid; i < tile_rows * D; i += nthreads) {
    const int row = i / D;
    const int c = i - row * D;
    float o = 0.0f, lsum = 0.0f;
#pragma unroll 4
    for (int k = 0; k < p.ks; ++k) {
      const size_t pr_row = size_t(k) * p.rows + row;
      o += part_acc[pr_row * D + c];
      lsum += part_ml[2 * pr_row + 1];
    }
    store_out(p, obase + size_t(row) * D + c, o / lsum);
  }
}

template <typename KT, int NE, int RPW, bool kMath>
int launch(const Params& p, int BH, int smem, cudaStream_t stream) {
  auto kern = paged_attention_kernel<KT, NE, RPW, kMath>;
  static int opted_in = 48 * 1024;   // the most this instance may take
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  const dim3 grid(BH, p.tiles);
  const dim3 block(p.rows / RPW * p.ks * kWarp);
  kern<<<grid, block, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename KT>
int dispatch(const Params& p, int BH, int ne, int rpw, int smem, bool math,
             cudaStream_t st) {
  if (!math)   // the probe keeps no accumulator: one instance per rpw
    return rpw == 1 ? launch<KT, 2, 1, false>(p, BH, smem, st)
                    : launch<KT, 2, 8, false>(p, BH, smem, st);
  switch (ne * 10 + rpw) {
    case 21: return launch<KT, 2, 1, true>(p, BH, smem, st);
    case 28: return launch<KT, 2, 8, true>(p, BH, smem, st);
    case 41: return launch<KT, 4, 1, true>(p, BH, smem, st);
    case 48: return launch<KT, 4, 8, true>(p, BH, smem, st);
    case 81: return launch<KT, 8, 1, true>(p, BH, smem, st);
    case 88: return launch<KT, 8, 8, true>(p, BH, smem, st);
    case 1: return launch<KT, 0, 1, true>(p, BH, smem, st);
  }
  return -1;
}

int launch_plan(const void* q, const void* k, const void* v,
                const void* k_scale, const void* v_scale, const void* tables,
                const void* pos, void* out, int B, int H, int S, int D,
                int NB, int BS, int T, int rows, int rpw, int ne, int kt,
                int stages, int ks, int copy_bytes, int rs, int stage,
                int dp, int q_off, int ml_off, int acc_off, int smem,
                float scale, int q_dtype, int kv_dtype, void* stream,
                bool math) {
  const int elem = kv_dtype == 0 ? 4 : kv_dtype == 1 ? 2 : 1;
  if (B < 1 || H < 1 || S < 1 || D < 1 || BS < 1 || T < 1 || NB < 1 ||
      (q_dtype != 0 && q_dtype != 1) || kv_dtype < 0 || kv_dtype > 2)
    return -1;
  if ((rpw != 1 && rpw != 8) || (ne == 0 && rpw != 1) ||
      (ne != 0 && ne != 2 && ne != 4 && ne != 8) ||
      (ne > 0 && ne * kWarp < D) ||
      rows < rpw || rows % rpw != 0 || ks < 1 || ks > kMaxRanges ||
      rows / rpw * ks > (rpw == 1 ? kMaxWarps1 : kMaxWarps))
    return -1;
  if (kt < 1 || kt > kMaxKT || kt > BS || stages < 2 ||
      stages > kMaxStages)
    return -1;
  if (copy_bytes != 0 && copy_bytes != 4 && copy_bytes != 8 &&
      copy_bytes != 16)
    return -1;
  if (copy_bytes != 0 && (D * elem) % copy_bytes != 0) return -1;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) return -1;
  // the kernel splits a tile's T x nsub sub-tiles in 32-bit arithmetic
  if (static_cast<long long>(T) * ((BS + kt - 1) / kt) * (ks + 1) >
      0x7fffffffLL)
    return -1;
  // the layout is the plan's; these hold what the kernel's vector reads
  // and the card need
  if (rs % 16 || rs < D * elem || stage % 16 || stage < 2 * kt * rs + 8 ||
      dp % 8 || dp < D || q_off % 16 || ml_off % 4 || acc_off % 4 ||
      q_off < 0 || ml_off < 0 || acc_off < 0 || q_off > smem ||
      ml_off > smem || acc_off > smem || smem > kMaxSmem)
    return -1;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.tables = static_cast<const int32_t*>(tables);
  p.pos = static_cast<const int32_t*>(pos);
  p.out = out;
  p.H = H;
  p.S = S;
  p.D = D;
  p.NB = NB;
  p.BS = BS;
  p.T = T;
  p.rows = rows;
  p.kt = kt;
  p.nsub = (BS + kt - 1) / kt;
  p.stages = stages;
  p.tiles = (S + rows - 1) / rows;
  p.ks = ks;
  p.copy_bytes = copy_bytes;
  p.rs = rs;
  p.stage = stage;
  p.dp = dp;
  p.q_off = q_off;
  p.ml_off = ml_off;
  p.acc_off = acc_off;
  p.q_bf16 = q_dtype == 1;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return dispatch<float>(p, B * H, ne, rpw, smem, math, st);
    case 1: return dispatch<__nv_bfloat16>(p, B * H, ne, rpw, smem, math, st);
    default: return dispatch<int8_t>(p, B * H, ne, rpw, smem, math, st);
  }
}

}  // namespace

// The launch plan (rows, rpw, ne, kt, stages, ks, copy_bytes) and its
// shared-memory layout (rs, stage, dp, the offsets, smem bytes; see
// Params) come from ops/cuda/paged_attention.py:plan; they are checked
// here and -1 returned for one the kernel does not take. dtype codes:
// 0 = float32, 1 = bfloat16, 2 = int8 (KV only; needs the [NB, H]
// float32 scales). Returns cudaGetLastError() after the launch.
extern "C" int paged_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* pos, void* out,
    int B, int H, int S, int D, int NB, int BS, int T, int rows, int rpw,
    int ne, int kt, int stages, int ks, int copy_bytes, int rs, int stage,
    int dp, int q_off, int ml_off, int acc_off, int smem, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  return launch_plan(q, k, v, k_scale, v_scale, tables, pos, out, B, H, S,
                     D, NB, BS, T, rows, rpw, ne, kt, stages, ks, copy_bytes,
                     rs, stage, dp, q_off, ml_off, acc_off, smem, scale,
                     q_dtype, kv_dtype, stream, true);
}

// The same arguments: the read probe (see the top of the file). out is
// not written.
extern "C" int paged_attention_read_probe(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* tables, const void* pos, void* out,
    int B, int H, int S, int D, int NB, int BS, int T, int rows, int rpw,
    int ne, int kt, int stages, int ks, int copy_bytes, int rs, int stage,
    int dp, int q_off, int ml_off, int acc_off, int smem, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  return launch_plan(q, k, v, k_scale, v_scale, tables, pos, out, B, H, S,
                     D, NB, BS, T, rows, rpw, ne, kt, stages, ks, copy_bytes,
                     rs, stage, dp, q_off, ml_off, acc_off, smem, scale,
                     q_dtype, kv_dtype, stream, false);
}

extern "C" const char* paged_attention_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
