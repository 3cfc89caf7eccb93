// The DRN's per-convolution epilogue for Hopper (sm_90a), in place:
//
//   y = relu((y + bias) + residual)
//
// over a convolution output y (N, C, H, W) in channels_last memory (C
// innermost), a float32 bias (C,), an optional residual of y's shape and
// layout.  The sums and the ReLU run in float32, in that order, and the
// result is rounded once to y's type (bfloat16 or float32), so it is
// bit-equal to drn_epilogue_reference in kernels/drn_epilogue.py.
//
// It replaces no TPU kernel: the JAX package's DRN leaves its eval
// BatchNorm, ReLU and residual add to XLA.  The port's folded DRN
// (models/drn.py FoldedDRN) moves each eval BN into the weights of the
// convolution before it; what is left of BN (its shift), the ReLU and the
// residual add is this one pass, where three PyTorch operators each read
// and wrote the whole activation.
//
// What bounds it on this card.  Two or three flops an element against 4
// bytes moved (bfloat16: read and write y) or 6 (and the residual):
// device-memory bandwidth, 3.35 TB/s.
//
// Design.  A thread takes 16 bytes of y (8 bfloat16 or 4 float32) of one
// pixel, neighbouring threads neighbouring channel vectors, so a warp
// reads and writes whole 32-byte sectors; the matching residual vector is
// one more 16-byte load, the biases one or two 16-byte loads through the
// read-only path (a few KB, they stay in L1).  A grid-stride loop over
// the vectors with a fixed number of blocks a multiprocessor (enough
// threads in flight to cover the memory latency); the stride's remainder
// modulo the channel vectors is computed once, so a thread steps its
// channel index with one add and one compare.  The launch allocates
// nothing and runs on the caller's stream, so a CUDA graph captures it.
//
// C interface: the entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename T, int N>
struct alignas(16) Vec {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// N consecutive float32 biases from the read-only path (N = 4 or 8).
template <int N>
__device__ __forceinline__ void load_bias(const float* __restrict__ bias,
                                          int64_t cv, float* out) {
  const float4* p = reinterpret_cast<const float4*>(bias) + cv * (N / 4);
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const float4 b = __ldg(p + i);
    out[4 * i] = b.x;
    out[4 * i + 1] = b.y;
    out[4 * i + 2] = b.z;
    out[4 * i + 3] = b.w;
  }
}

// vecs = pixels * cvecs vectors of N values; cvecs = C / N; step =
// (gridDim.x * blockDim.x) % cvecs.
template <typename T, int N, bool kResidual>
__global__ void __launch_bounds__(kThreads)
    epilogue_kernel(T* __restrict__ y, const float* __restrict__ bias,
                    const T* __restrict__ residual, int64_t vecs,
                    int64_t cvecs, int64_t step) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  int64_t cv = t % cvecs;
  Vec<T, N>* yv = reinterpret_cast<Vec<T, N>*>(y);
  const Vec<T, N>* rv = reinterpret_cast<const Vec<T, N>*>(residual);
  for (; t < vecs; t += stride) {
    Vec<T, N> a = yv[t];
    Vec<T, N> r;
    if constexpr (kResidual) r = rv[t];
    float b[N];
    load_bias<N>(bias, cv, b);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      float v = __fadd_rn(to_float(a.v[l]), b[l]);
      if constexpr (kResidual) v = __fadd_rn(v, to_float(r.v[l]));
      v = v < 0.f ? 0.f : v;  // NaN stays NaN
      a.v[l] = from_float<T>(v);
    }
    yv[t] = a;
    cv += step;
    if (cv >= cvecs) cv -= cvecs;
  }
}

int sm_count() {
  static int count = 0;  // the one card a process drives; read once
  if (count == 0) {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 132;
    count = n;
  }
  return count;
}

template <typename T, bool kResidual>
void launch(void* y, const void* bias, const void* residual, int64_t pixels,
            int64_t c, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t cvecs = c / kVec;
  const int64_t vecs = pixels * cvecs;
  int64_t grid = (vecs + kThreads - 1) / kThreads;
  const int64_t most = (int64_t)sm_count() * kBlocksPerSM;
  if (grid > most) grid = most;
  const int64_t step = (grid * kThreads) % cvecs;
  epilogue_kernel<T, kVec, kResidual>
      <<<static_cast<int>(grid), kThreads, 0, s>>>(
          static_cast<T*>(y), static_cast<const float*>(bias),
          static_cast<const T*>(residual), vecs, cvecs, step);
}

template <typename T>
void dispatch(void* y, const void* bias, const void* residual,
              int64_t pixels, int64_t c, cudaStream_t s) {
  if (residual != nullptr)
    launch<T, true>(y, bias, residual, pixels, c, s);
  else
    launch<T, false>(y, bias, residual, pixels, c, s);
}

}  // namespace

// y (pixels, C) in place; bias (C,) float32; residual (pixels, C) or null.
// pixels = N * H * W.  The wrapper checks that C is a multiple of the
// vector (8 bfloat16, 4 float32) and that every pointer is 16-byte
// aligned; a C or a dtype this cannot take returns cudaErrorInvalidValue.
extern "C" int spalign_drn_epilogue(void* y, const void* bias,
                                    const void* residual, int64_t pixels,
                                    int64_t c, int dtype,
                                    void* stream) {
  if (pixels <= 0 || c <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && c % 8 == 0) {
    dispatch<__nv_bfloat16>(y, bias, residual, pixels, c, s);
  } else if (dtype == kF32 && c % 4 == 0) {
    dispatch<float>(y, bias, residual, pixels, c, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
