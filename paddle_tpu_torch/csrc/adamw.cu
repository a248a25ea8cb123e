// Multi-tensor AdamW (and Adam: coeff 0) update for Hopper (sm_90a).
//
// Not the port of a TPU kernel: the JAX package's update
// (paddle_tpu/ops/optimizer_ops.py:40-71, _adam/_adamw) is plain jnp that XLA
// fuses into the compiled train step. This kernel is the port's counterpart
// of that fusion: one launch updates every parameter of a group (same
// parameter dtype, moment dtype and device) in place, where the eager
// per-parameter loop launched ~23 kernels per parameter.
//
// What it computes, per element, is paddle_tpu_torch/ops/optimizer_ops.py:
// adamw (Paddle's form) for parameters P and moments M, each float32,
// bfloat16 or float16, bit for bit as the per-op PyTorch path computes it
// on the card. Each operation of that path computes in float32 and rounds
// its result to the dtype that PyTorch's promotion gives it: R_T below,
// with MP = promote(M, P) (P for equal dtypes, else float32) and the beta
// powers stored in P, as the optimizer creates them:
//   a1  = R_M(beta1_M * m1)        beta1_M: beta1 rounded to M (jnp's scalar
//   a2  = R_M(beta2_M * m2)        promotion)
//   m1' = R_MP(a1 + R_P(f32(1 - beta1) * g))
//   m2' = R_MP(a2 + R_P(R_P(f32(1 - beta2) * g) * g))
//   b1p' = R_P(b1p * beta1), b2p' = R_P(b2p * beta2)
//   lr_t = R_P(R_P(lr * R_P(sqrt(R_P(1 - b2p')))) / R_P(1 - b1p'))
//   p'  = R_P(R_MP(R_MP(p - R_MP(R_MP(lr_t * m1') / R_MP(R_MP(sqrt(m2'))
//               + eps))) - R_P((lr * coeff) * p)))
// and at coeff 0 (Adam, the adam op) p' = R_P(R_MP(p - ...)) with no decay
// term.
// m1' and m2' are stored rounded to M; the update uses them at MP. lr is the
// entry's own learning rate (each table entry points at its slot of the
// optimizer's float32 [k] lr tensor: one slot per distinct lr_scale, so
// parameters of different scales share one launch). With a grad_scale
// (GradientClipByGlobalNorm's clip / max(norm, clip), float32 holding the
// value in the gradients' or a wider dtype), g is first R_P(g * scale), as
// the reference rounds its clipped gradient into the update; a null
// grad_scale leaves g as it is. With
// float32 parameters every R_P and R_MP is exact, which leaves the float32
// sequence with only beta * m rounded to M. Every operation is an _rn
// intrinsic, so nothing is contracted into an FMA that the per-op path does
// not contract, whatever the flags.
//
// Bound: bytes. Per element p is read and written, g read, m1 and m2 read
// and written (20 B with float32 parameters and bf16 moments) against ~15
// f32 operations: at gpt2-medium's ~355M parameters that is ~7.1 GB, ~2.1
// ms at 3.35 TB/s.
//
// Design. The wrapper (ops/cuda/adamw.py) builds a device table of the
// group's static pointers (p, m1, m2, b1p, b2p, lr), sizes and first chunk
// once per parameter set and keeps it. The gradients' pointers, which change
// whenever autograd allocates new gradients, are kernel arguments: a CUDA
// graph bakes them by value at capture, as it bakes every kernel argument.
// Block b walks chunk b of the group (kChunk elements of one tensor, found
// by a binary search over the table's first-chunk column), with 16-byte
// (float32) or 8-byte (16-bit) accesses of four elements where the
// tensor's pointers allow them. Every block of a tensor reads the old beta
// powers; the last block of that tensor to arrive (an atomic count per
// tensor in the table) writes the new ones and resets the count, so no
// block reads a power another block has already advanced.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16384;       // elements per block: 16 x 4 a thread
// gradient pointers passed by value in one launch: 448 x 8 B keeps the
// kernel's arguments under the classic 4 KB limit
constexpr int kMaxTensors = 448;

// One tensor of the group, 72 bytes; the wrapper writes these words.
struct Entry {
  void* p;
  void* m1;
  void* m2;
  void* b1p;         // [1] in the parameters' dtype
  void* b2p;
  const float* lr;   // the tensor's slot of the optimizer's lr tensor
  long long n;       // elements
  long long first;   // index of the tensor's first chunk in the group
  int arrive;        // blocks that have read b1p/b2p in this launch
  int chunks;        // max(1, ceil(n / kChunk)): an empty tensor still steps
};
static_assert(sizeof(Entry) == 72, "the wrapper packs 9 words per tensor");

struct Grads {
  const void* g[kMaxTensors];
};

struct Scalars {
  float c1, c2;        // beta1, beta2 rounded to the moments' dtype
  float beta1, beta2;  // f32, for the beta powers
  float omb1, omb2;    // f32(1 - beta1), f32(1 - beta2)
  float eps, coeff;
};

// The dtype PyTorch's promotion gives an operation on two dtypes: the
// dtype itself when they agree, float32 otherwise (bf16 with f16 too).
template <typename A, typename B>
struct Promote {
  using type = float;
};
template <typename A>
struct Promote<A, A> {
  using type = A;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// R_T: x rounded to T's precision, kept as a float.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

template <typename P, typename M>
__device__ __forceinline__ void update(float& p, float g, float& m1,
                                       float& m2, float lr_t, float decay,
                                       const float* gscale,
                                       const Scalars& s) {
  using MP = typename Promote<M, P>::type;
  if (gscale != nullptr) g = rnd<P>(__fmul_rn(g, *gscale));
  const float a1 = rnd<M>(__fmul_rn(m1, s.c1));
  const float a2 = rnd<M>(__fmul_rn(m2, s.c2));
  m1 = rnd<MP>(__fadd_rn(a1, rnd<P>(__fmul_rn(s.omb1, g))));
  m2 = rnd<MP>(__fadd_rn(
      a2, rnd<P>(__fmul_rn(rnd<P>(__fmul_rn(s.omb2, g)), g))));
  const float num = rnd<MP>(__fmul_rn(lr_t, m1));
  const float den = rnd<MP>(__fadd_rn(rnd<MP>(__fsqrt_rn(m2)), s.eps));
  const float adam = rnd<MP>(__fsub_rn(p, rnd<MP>(__fdiv_rn(num, den))));
  // coeff 0 is Adam: no decay term at all (p - 0 * p would turn an
  // infinite parameter into NaN where the adam op keeps it)
  p = s.coeff != 0.0f
          ? rnd<P>(rnd<MP>(__fsub_rn(adam, rnd<P>(__fmul_rn(decay, p)))))
          : rnd<P>(adam);
}

// Four consecutive elements: one 16-byte (f32) or 8-byte (16-bit) access.
template <typename T>
__device__ __forceinline__ float4 load4(const T* m, long long v) {
  if constexpr (sizeof(T) == 4) {
    return reinterpret_cast<const float4*>(m)[v];
  } else {
    const uint2 u = reinterpret_cast<const uint2*>(m)[v];
    const T* h = reinterpret_cast<const T*>(&u);
    return make_float4(to_f(h[0]), to_f(h[1]), to_f(h[2]), to_f(h[3]));
  }
}
template <typename T>
__device__ __forceinline__ void store4(T* m, long long v, float4 x) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(m)[v] = x;
  } else {
    uint2 u;
    T* h = reinterpret_cast<T*>(&u);
    h[0] = from_f<T>(x.x);
    h[1] = from_f<T>(x.y);
    h[2] = from_f<T>(x.z);
    h[3] = from_f<T>(x.w);
    reinterpret_cast<uint2*>(m)[v] = u;
  }
}

template <typename T>
__device__ __forceinline__ bool aligned4(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
          (4 * sizeof(T))) == 0;
}

// Block b updates chunk c0 + b of the group: tensors t0 .. t0 + nt - 1.
template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_multi_kernel(Entry* __restrict__ table, int t0, int nt, int c0,
                       const Grads grads,
                       const float* __restrict__ grad_scale,
                       const Scalars s) {
  __shared__ P* sp;
  __shared__ const P* sg;
  __shared__ M* sm1;
  __shared__ M* sm2;
  __shared__ long long sbegin, send;
  __shared__ float slr_t, sdecay, sgscale;
  if (threadIdx.x == 0) {
    const int c = c0 + static_cast<int>(blockIdx.x);
    int lo = t0, hi = t0 + nt - 1;     // the last tensor whose first <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid].first <= c) lo = mid; else hi = mid - 1;
    }
    Entry& e = table[lo];
    P* b1p = static_cast<P*>(e.b1p);
    P* b2p = static_cast<P*>(e.b2p);
    const float b1 = rnd<P>(__fmul_rn(to_f(*b1p), s.beta1));
    const float b2 = rnd<P>(__fmul_rn(to_f(*b2p), s.beta2));
    const float l = *e.lr;
    if (grad_scale != nullptr) sgscale = *grad_scale;
    const float root = rnd<P>(__fsqrt_rn(rnd<P>(__fsub_rn(1.0f, b2))));
    slr_t = rnd<P>(__fdiv_rn(rnd<P>(__fmul_rn(l, root)),
                             rnd<P>(__fsub_rn(1.0f, b1))));
    sdecay = __fmul_rn(l, s.coeff);
    sp = static_cast<P*>(e.p);
    sg = static_cast<const P*>(grads.g[lo - t0]);
    sm1 = static_cast<M*>(e.m1);
    sm2 = static_cast<M*>(e.m2);
    sbegin = static_cast<long long>(c - e.first) * kChunk;
    send = min(e.n, sbegin + kChunk);
    // b1p/b2p were read above; the last block of the tensor writes them
    __threadfence();
    if (atomicAdd(&e.arrive, 1) == e.chunks - 1) {
      *b1p = from_f<P>(b1);
      *b2p = from_f<P>(b2);
      e.arrive = 0;
    }
  }
  __syncthreads();
  P* p = sp;
  const P* g = sg;
  M* m1 = sm1;
  M* m2 = sm2;
  const long long begin = sbegin, end = send;
  const float lr_t = slr_t, decay = sdecay;
  const float* gs = grad_scale != nullptr ? &sgscale : nullptr;
  long long tail = begin;
  if (aligned4<P>(p, g) && aligned4<M>(m1, m2)) {
    // begin is a multiple of kChunk, so of 4
    const long long v0 = begin / 4, v1 = end / 4;
    for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) {
      float4 pv = load4(p, v);
      const float4 gv = load4(g, v);
      float4 a = load4(m1, v);
      float4 b = load4(m2, v);
      update<P, M>(pv.x, gv.x, a.x, b.x, lr_t, decay, gs, s);
      update<P, M>(pv.y, gv.y, a.y, b.y, lr_t, decay, gs, s);
      update<P, M>(pv.z, gv.z, a.z, b.z, lr_t, decay, gs, s);
      update<P, M>(pv.w, gv.w, a.w, b.w, lr_t, decay, gs, s);
      store4(p, v, pv);
      store4(m1, v, a);
      store4(m2, v, b);
    }
    tail = v1 * 4;
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pv = to_f(p[i]);
    float a = to_f(m1[i]);
    float b = to_f(m2[i]);
    update<P, M>(pv, to_f(g[i]), a, b, lr_t, decay, gs, s);
    p[i] = from_f<P>(pv);
    m1[i] = from_f<M>(a);
    m2[i] = from_f<M>(b);
  }
}

template <typename P, typename M>
void launch(Entry* tb, int t0, int nt, int c0, int nchunks, const Grads& gr,
            const float* gsc, const Scalars& s, cudaStream_t st) {
  adamw_multi_kernel<P, M><<<nchunks, kThreads, 0, st>>>(tb, t0, nt, c0, gr,
                                                         gsc, s);
}

// dtype codes: 0 float32, 1 bfloat16, 2 float16
template <typename P>
bool launch_p(int mdtype, Entry* tb, int t0, int nt, int c0, int nchunks,
              const Grads& gr, const float* gsc, const Scalars& s,
              cudaStream_t st) {
  switch (mdtype) {
    case 0: launch<P, float>(tb, t0, nt, c0, nchunks, gr, gsc, s, st); break;
    case 1:
      launch<P, __nv_bfloat16>(tb, t0, nt, c0, nchunks, gr, gsc, s, st);
      break;
    case 2: launch<P, __half>(tb, t0, nt, c0, nchunks, gr, gsc, s, st); break;
    default: return false;
  }
  return true;
}

}  // namespace

// Launches the update of tensors t0 .. t0 + nt - 1 of the table (chunks c0 ..
// c0 + nchunks - 1 of the group), nt <= adamw_max_tensors(). grads holds the
// nt gradient pointers (host memory, copied into the kernel's arguments);
// grad_scale is a float32 [1] tensor on the card, or null for none (each
// entry's learning rate is in the table). pdtype (parameters, gradients, beta
// powers) and mdtype (moments): 0 = float32, 1 = bfloat16, 2 = float16.
// Returns cudaGetLastError() after the launch, or -1 for arguments it does
// not take.
extern "C" int adamw_multi_launch(void* table, int t0, int nt, int c0,
                                  int nchunks, const void* grads,
                                  const void* grad_scale, float c1, float c2,
                                  float beta1, float beta2, float omb1,
                                  float omb2, float eps, float coeff,
                                  int pdtype, int mdtype, void* stream) {
  if (nt < 1 || nt > kMaxTensors || t0 < 0 || c0 < 0 || nchunks < 1)
    return -1;
  Grads gr;
  const void* const* src = static_cast<const void* const*>(grads);
  for (int i = 0; i < nt; ++i) gr.g[i] = src[i];
  const Scalars s{c1, c2, beta1, beta2, omb1, omb2, eps, coeff};
  Entry* tb = static_cast<Entry*>(table);
  const float* l = static_cast<const float*>(grad_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool ok;
  switch (pdtype) {
    case 0:
      ok = launch_p<float>(mdtype, tb, t0, nt, c0, nchunks, gr, l, s, st);
      break;
    case 1:
      ok = launch_p<__nv_bfloat16>(mdtype, tb, t0, nt, c0, nchunks, gr, l,
                                   s, st);
      break;
    case 2:
      ok = launch_p<__half>(mdtype, tb, t0, nt, c0, nchunks, gr, l, s, st);
      break;
    default: ok = false;
  }
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int adamw_chunk() { return kChunk; }

extern "C" int adamw_max_tensors() { return kMaxTensors; }

extern "C" const char* adamw_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
