// Greedy non-maximum suppression over score-sorted candidates, for Hopper
// (sm_90a): the suppression loop of multiclass_nms.
//
// Replaces the reference's per-class fori_loop over an M x M IoU matrix
// (paddle_tpu/ops/detection_ops.py:280-300, XLA-compiled, not a Pallas
// kernel). The port's multiclass_nms sorts each (image, class) row once and
// keeps its first W candidates (nms_top_k plus the ties at the k-th score);
// this kernel then runs the greedy loop for every row at once: one block per
// row walks the W candidates in order, every thread testing the IoU of
// candidate i against its share of the kept j < i, and a block-wide OR
// (__syncthreads_or) decides whether i is kept. The kept flags live in
// shared memory; the boxes are read from global memory (L1/L2 resident).
//
// The IoU is computed operation by operation as the plain version's torch
// elementwise kernels compute it (each rounded once: explicit _rn
// intrinsics, no contraction into fused multiply-adds), so the decisions
// are bit-identical to the plain version's, at T = float or double:
//   area(z) = max(z2 - z0 + off, 0) * max(z3 - z1 + off, 0)
//   inter   = max(min(a2, b2) - max(a0, b0) + off, 0)
//           * max(min(a3, b3) - max(a1, b1) + off, 0)
//   union   = (area(a) + area(b)) - inter
//   iou     = union > 0 ? inter / union : 0
// and candidate i is suppressed when iou > thresh for a kept j < i.
//
// Bound: the rows' boxes, scores and flags once through memory, and the
// IoUs of every (alive i, kept j < i) pair, ~17 operations each; the
// loop's W block-wide barriers per row are latency, not work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__device__ __forceinline__ T relu_(T x) { return x > T(0) ? x : T(0); }

template <typename T>
__device__ __forceinline__ T area(const T* z, T off) {
  return mul_rn(relu_(add_rn(sub_rn(z[2], z[0]), off)),
                relu_(add_rn(sub_rn(z[3], z[1]), off)));
}

template <typename T>
__global__ void nms_keep_kernel(const T* __restrict__ boxes,
                                const T* __restrict__ scores,
                                uint8_t* __restrict__ keep, int w, T thresh,
                                T off) {
  extern __shared__ uint8_t kept[];
  const size_t row = blockIdx.x;
  const T* b = boxes + row * static_cast<size_t>(w) * 4;
  const T* s = scores + row * static_cast<size_t>(w);
  for (int i = threadIdx.x; i < w; i += blockDim.x) kept[i] = 0;
  __syncthreads();
  for (int i = 0; i < w; ++i) {
    const bool alive = s[i] > -static_cast<T>(INFINITY);
    int hit = 0;
    if (alive) {
      const T* a = b + 4 * static_cast<size_t>(i);
      const T a0 = a[0], a1 = a[1], a2 = a[2], a3 = a[3];
      const T area_a = area(a, off);
      for (int j = threadIdx.x; j < i && !hit; j += blockDim.x) {
        if (!kept[j]) continue;
        const T* c = b + 4 * static_cast<size_t>(j);
        const T iw = relu_(add_rn(sub_rn(c[2] < a2 ? c[2] : a2,
                                         c[0] > a0 ? c[0] : a0), off));
        const T ih = relu_(add_rn(sub_rn(c[3] < a3 ? c[3] : a3,
                                         c[1] > a1 ? c[1] : a1), off));
        const T inter = mul_rn(iw, ih);
        const T uni = sub_rn(add_rn(area_a, area(c, off)), inter);
        const T iou = uni > T(0) ? div_rn(inter, uni) : T(0);
        hit = iou > thresh;
      }
    }
    hit = __syncthreads_or(hit);
    if (threadIdx.x == 0) kept[i] = alive && !hit;
    __syncthreads();
  }
  uint8_t* k = keep + row * static_cast<size_t>(w);
  for (int i = threadIdx.x; i < w; i += blockDim.x) k[i] = kept[i];
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* boxes, const void* scores, void* keep, int rows, int w,
           double thresh, double off, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(w);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        nms_keep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_keep_kernel<T><<<rows, kThreads, smem, stream>>>(
      static_cast<const T*>(boxes), static_cast<const T*>(scores),
      static_cast<uint8_t*>(keep), w, static_cast<T>(thresh),
      static_cast<T>(off));
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : static_cast<int>(e);
}

}  // namespace

// dtype: 0 float32, 1 float64. Returns 0 or a cudaError_t.
extern "C" int nms_keep_launch(const void* boxes, const void* scores,
                               void* keep, int rows, int w, double thresh,
                               double off, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows < 1 || w < 1) return 0;
  if (dtype == 0)
    return launch<float>(boxes, scores, keep, rows, w, thresh, off, s);
  if (dtype == 1)
    return launch<double>(boxes, scores, keep, rows, w, thresh, off, s);
  return -1;
}

extern "C" const char* nms_error_string(int code) {
  if (code == -1) return "unsupported dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
