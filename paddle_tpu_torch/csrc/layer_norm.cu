// LayerNorm forward and backward over the last axis, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of paddle_tpu/ops/pallas/layer_norm.py:
//   ln_fwd_kernel                    <- _fwd_kernel (pallas_call in _ln_fwd, :70)
//   ln_bwd_kernel + ln_bwd_reduce    <- _bwd_kernel (pallas_call in _ln_bwd, :96)
// Same functions on x [n, h] (f32 or bf16; gamma and beta in x's dtype or
// f32; all arithmetic in f32): the forward emits y in x's dtype and the f32
// row statistics mean and rstd = rsqrt(var + eps), the variance taken as the
// mean of (x - mean)^2 after the mean, in the reference's order (not
// Welford). The backward emits dx in x's dtype and dgamma = sum(dy * xhat),
// dbeta = sum(dy), summed over all rows in f32 and rounded once to gamma's
// dtype.
//
// Bound: both are memory bound on the H100 (a few FLOPs per element against
// 8 to 12 bytes of f32 traffic): at the train step's f32 [8192, 1024] rows
// the forward must move 67 MB (x in, y out) and the backward 101 MB (x and dy
// in, dx out), 0.020 and 0.030 ms at 3.35 TB/s.
//
// Design (simple and correct first): one block of 256 threads per row in the
// forward; each thread keeps its V = ceil(h / 256) elements (columns
// tid + 256 i) in registers, so x is read from device memory once and the
// two row reductions (mean, then the centred variance) are block reductions:
// a warp shuffle tree, then the 8 warp sums added in order by every thread.
// The TPU backward adds each row block's dgamma/dbeta into one output block
// revisited across a sequential grid; a GPU grid runs in parallel, so the
// backward is a deterministic two-stage reduce without atomics: P blocks
// (P = min(n, 528), 4 per SM) each walk rows blockIdx.x, +P, ..., writing dx
// and keeping per-column partial sums in registers, stored to an f32 [2, P, h]
// scratch; then ln_bwd_reduce sums the P partials of each column in a fixed
// order. h is capped at 8192 (32 registers per thread per row array).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxH = 32 * kThreads;
constexpr int kRedCols = 32;   // columns per block of the partials reduce
constexpr int kRedRows = 32;   // row groups per block of the partials reduce

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The block's sum of v (a, b), returned to every thread. red holds 2 *
// kWarps floats of shared memory; the leading barrier lets a block call this
// again right after a previous call.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int warp = static_cast<int>(threadIdx.x) / 32;
  __syncthreads();
  if (threadIdx.x % 32 == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  float2 t = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    t.x += red[w];
    t.y += red[kWarps + w];
  }
  return t;
}

template <typename T, typename G, int V>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                  const G* __restrict__ beta, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd, int H,
                  float eps) {
  __shared__ float red[2 * kWarps];
  const size_t row = blockIdx.x;
  const T* xr = x + row * H;
  const int tid = static_cast<int>(threadIdx.x);
  float v[V];
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = tid + i * kThreads;
    v[i] = c < H ? to_f32(xr[c]) : 0.0f;
    s += v[i];
  }
  const float mu = block_sum2(s, 0.0f, red).x / H;
  float q = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = tid + i * kThreads;
    v[i] = c < H ? v[i] - mu : 0.0f;
    q += v[i] * v[i];
  }
  const float r = rsqrtf(block_sum2(q, 0.0f, red).x / H + eps);
  T* yr = y + row * H;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = tid + i * kThreads;
    if (c < H) store(&yr[c], v[i] * r * to_f32(gamma[c]) + to_f32(beta[c]));
  }
  if (tid == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

// Stage 1 of the backward: dx of rows blockIdx.x, +gridDim.x, ...; the
// block's per-column partial sums of dy * xhat and dy go to part[0][block]
// and part[1][block] (each [P, H]).
template <typename T, typename G, int V>
__global__ void __launch_bounds__(kThreads)
    ln_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ part, int N,
                  int H) {
  __shared__ float red[2 * kWarps];
  const int tid = static_cast<int>(threadIdx.x);
  float g[V], pg[V], pb[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = tid + i * kThreads;
    g[i] = c < H ? to_f32(gamma[c]) : 0.0f;
    pg[i] = 0.0f;
    pb[i] = 0.0f;
  }
  for (int row = static_cast<int>(blockIdx.x); row < N;
       row += static_cast<int>(gridDim.x)) {
    const size_t off = size_t(row) * H;
    const float mu = mean[row];
    const float r = rstd[row];
    float xh[V], d[V];
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = tid + i * kThreads;
      const bool live = c < H;
      xh[i] = live ? (to_f32(x[off + c]) - mu) * r : 0.0f;
      d[i] = live ? to_f32(dy[off + c]) : 0.0f;
      const float dyg = d[i] * g[i];
      s1 += dyg;
      s2 += dyg * xh[i];
      pg[i] += d[i] * xh[i];
      pb[i] += d[i];
    }
    const float2 m = block_sum2(s1, s2, red);
    const float m1 = m.x / H;
    const float m2 = m.y / H;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = tid + i * kThreads;
      if (c < H) store(&dx[off + c], r * (d[i] * g[i] - m1 - xh[i] * m2));
    }
  }
  const size_t P = gridDim.x;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = tid + i * kThreads;
    if (c < H) {
      part[size_t(blockIdx.x) * H + c] = pg[i];
      part[(P + blockIdx.x) * H + c] = pb[i];
    }
  }
}

// Stage 2: dgamma[c] and dbeta[c] = the sums of the P partials of column c.
// Block (kRedCols, kRedRows): thread (tx, ty) sums rows ty, ty + kRedRows,
// ... in order, then thread ty == 0 adds the kRedRows sums in order.
template <typename G>
__global__ void __launch_bounds__(kRedCols * kRedRows)
    ln_bwd_reduce(const float* __restrict__ part, G* __restrict__ dgamma,
                  G* __restrict__ dbeta, int P, int H) {
  __shared__ float sg[kRedRows][kRedCols];
  __shared__ float sb[kRedRows][kRedCols];
  const int tx = static_cast<int>(threadIdx.x);
  const int ty = static_cast<int>(threadIdx.y);
  const int c = static_cast<int>(blockIdx.x) * kRedCols + tx;
  float a = 0.0f, b = 0.0f;
  if (c < H) {
    for (int p = ty; p < P; p += kRedRows) {
      a += part[size_t(p) * H + c];
      b += part[(size_t(P) + p) * H + c];
    }
  }
  sg[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < H) {
    for (int r = 1; r < kRedRows; ++r) {
      a += sg[r][tx];
      b += sb[r][tx];
    }
    store(&dgamma[c], a);
    store(&dbeta[c], b);
  }
}

template <typename T, typename G, int V>
int fwd(const void* x, const void* gamma, const void* beta, void* y,
        void* mean, void* rstd, int N, int H, float eps, cudaStream_t st) {
  ln_fwd_kernel<T, G, V><<<N, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const G*>(beta), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), H, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename G, int V>
int bwd(const void* x, const void* gamma, const void* mean, const void* rstd,
        const void* dy, void* dx, void* dgamma, void* dbeta, void* part,
        int N, int H, int P, cudaStream_t st) {
  ln_bwd_kernel<T, G, V><<<P, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const G*>(gamma),
      static_cast<const float*>(mean), static_cast<const float*>(rstd),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(part), N, H);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  ln_bwd_reduce<G><<<(H + kRedCols - 1) / kRedCols, dim3(kRedCols, kRedRows),
                     0, st>>>(static_cast<const float*>(part),
                              static_cast<G*>(dgamma),
                              static_cast<G*>(dbeta), P, H);
  return static_cast<int>(cudaGetLastError());
}

// Dispatch on (x dtype, gamma dtype) and V = ceil(h / 256) rounded up to a
// power of two. Codes: 0 = float32, 1 = bfloat16; gamma is x's type or f32.
#define LN_BY_V(FN, T, G, ...)                                          \
  do {                                                                  \
    if (H <= 1 * kThreads) return FN<T, G, 1>(__VA_ARGS__);             \
    if (H <= 2 * kThreads) return FN<T, G, 2>(__VA_ARGS__);             \
    if (H <= 4 * kThreads) return FN<T, G, 4>(__VA_ARGS__);             \
    if (H <= 8 * kThreads) return FN<T, G, 8>(__VA_ARGS__);             \
    if (H <= 16 * kThreads) return FN<T, G, 16>(__VA_ARGS__);           \
    return FN<T, G, 32>(__VA_ARGS__);                                   \
  } while (0)

#define LN_DISPATCH(FN, ...)                                            \
  do {                                                                  \
    if (xdtype == 0 && gdtype == 0) LN_BY_V(FN, float, float, __VA_ARGS__); \
    if (xdtype == 1 && gdtype == 1)                                     \
      LN_BY_V(FN, __nv_bfloat16, __nv_bfloat16, __VA_ARGS__);           \
    if (xdtype == 1 && gdtype == 0)                                     \
      LN_BY_V(FN, __nv_bfloat16, float, __VA_ARGS__);                   \
    return -1;                                                          \
  } while (0)

bool bad_shape(int N, int H) { return N < 1 || H < 1 || H > kMaxH; }

}  // namespace

// Each returns cudaGetLastError() after its launches, or -1 for arguments it
// does not take. mean and rstd are float32 [N]; part is float32 [2, P, H]
// scratch with 1 <= P <= N.
extern "C" int ln_fwd_launch(const void* x, const void* gamma,
                             const void* beta, void* y, void* mean,
                             void* rstd, int N, int H, float eps, int xdtype,
                             int gdtype, void* stream) {
  if (bad_shape(N, H)) return -1;
  LN_DISPATCH(fwd, x, gamma, beta, y, mean, rstd, N, H, eps,
              static_cast<cudaStream_t>(stream));
}

extern "C" int ln_bwd_launch(const void* x, const void* gamma,
                             const void* mean, const void* rstd,
                             const void* dy, void* dx, void* dgamma,
                             void* dbeta, void* part, int N, int H, int P,
                             int xdtype, int gdtype, void* stream) {
  if (bad_shape(N, H) || P < 1 || P > N) return -1;
  LN_DISPATCH(bwd, x, gamma, mean, rstd, dy, dx, dgamma, dbeta, part, N, H,
              P, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ln_error_string(int code) {
  if (code < 0) return "unsupported arguments";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
