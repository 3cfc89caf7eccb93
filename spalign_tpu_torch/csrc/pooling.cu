// SegNet's 2x2 argmax pooling and index unpooling for Hopper (sm_90a).
//
// Replaces the three TPU kernels of spalign_tpu/kernels/pooling_pallas.py:
//   spalign_pool2x2    <- _pool_kernel    (pool2x2_pallas)
//   spalign_scatter2x2 <- _scatter_kernel (scatter2x2_pallas)
//   spalign_gather2x2  <- _gather_kernel  (gather2x2_pallas)
// Same functions, over contiguous NHWC float32 or bfloat16 tensors:
//   * pool: each 2x2 window of x (N, 2h, 2w, C) gives its maximum and an
//     int8 code 2*dy + dx of the element taken, the first maximum in the
//     order (0,0), (0,1), (1,0), (1,1) (Chainer's rule; a scan with a
//     strict > gives it).  An all -inf window gives -inf and code 0.
//   * scatter (unpool forward, pool backward): each value of x (N, h, w, C)
//     goes to its code's position of a 2x2 window of out (N, 2h, 2w, C);
//     the other three positions are written as zero.
//   * gather (unpool backward): each element of out (N, h, w, C) takes
//     g (N, 2h, 2w, C) at its code's position.
// bfloat16 compares in float32 (the conversion is exact) and moves the
// selected element's bits, so every result is bit-equal to the plain
// PyTorch versions in kernels/pooling.py.
//
// What bounds them on this card.  A few compares per element against 4
// to 5.25 bytes moved per big-side element (pool reads x once and writes
// a quarter of it plus the int8 codes; scatter and gather move the same
// bytes the other way): device-memory bandwidth, 3.35 TB/s.
//
// Design (simple, right first).  One thread takes one pooled pixel and a
// vector of channels: 16 bytes per load or store (4 float32 or 8
// bfloat16), neighbouring threads on neighbouring channels, so a warp
// touches whole 32-byte sectors; a scalar instantiation takes channel
// counts that are no multiple of the vector or unaligned pointers.  Each
// thread issues its four big-side loads (or stores) before it uses them.
// Grid-stride loops over the pooled pixels.  Every output element is
// written, so the wrapper allocates with torch.empty and nothing is
// cleared first.  The TPU kernels' lane-group reshapes and VMEM column
// blocking existed for Mosaic's (8, 128) tiling and have no counterpart.
//
// C interface: each entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 8192;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <int N>
struct alignas(N) Codes {
  int8_t v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16(static_cast<unsigned short>(0));
}

// Offsets of work item t: `small` of the pooled pixel's channel vector in
// the (N, h, w, C) tensors, `big` of its window's (0, 0) element in the
// (N, 2h, 2w, C) tensor.  rows = N * h; pooled row r is big row 2r.
struct Item {
  int64_t small, big;
};

template <int N>
__device__ __forceinline__ Item item_of(int64_t t, int64_t w, int64_t c) {
  const int64_t vecs = c / N;
  const int64_t cv = t % vecs;
  const int64_t p = t / vecs;  // pooled pixel r * w + j
  const int64_t j = p % w;
  const int64_t r = p / w;
  return {p * c + cv * N, (2 * r * (2 * w) + 2 * j) * c + cv * N};
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    pool_kernel(const T* __restrict__ x, T* __restrict__ pooled,
                int8_t* __restrict__ codes, int64_t rows, int64_t w,
                int64_t c) {
  const int64_t total = rows * w * (c / N);
  const int64_t down = 2 * w * c;  // one big-side row
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       t < total; t += (int64_t)gridDim.x * blockDim.x) {
    const Item it = item_of<N>(t, w, c);
    const Vec<T, N> a = *reinterpret_cast<const Vec<T, N>*>(x + it.big);
    const Vec<T, N> b = *reinterpret_cast<const Vec<T, N>*>(x + it.big + c);
    const Vec<T, N> d =
        *reinterpret_cast<const Vec<T, N>*>(x + it.big + down);
    const Vec<T, N> e =
        *reinterpret_cast<const Vec<T, N>*>(x + it.big + down + c);
    Vec<T, N> out;
    Codes<N> code;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      T best = a.v[l];
      float m = to_float(best);
      int8_t k = 0;
      float f = to_float(b.v[l]);
      if (f > m) { m = f; best = b.v[l]; k = 1; }
      f = to_float(d.v[l]);
      if (f > m) { m = f; best = d.v[l]; k = 2; }
      f = to_float(e.v[l]);
      if (f > m) { best = e.v[l]; k = 3; }
      out.v[l] = best;
      code.v[l] = k;
    }
    *reinterpret_cast<Vec<T, N>*>(pooled + it.small) = out;
    *reinterpret_cast<Codes<N>*>(codes + it.small) = code;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const T* __restrict__ x, const int8_t* __restrict__ codes,
                   T* __restrict__ out, int64_t rows, int64_t w, int64_t c) {
  const int64_t total = rows * w * (c / N);
  const int64_t down = 2 * w * c;
  const T z = zero_of<T>();
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       t < total; t += (int64_t)gridDim.x * blockDim.x) {
    const Item it = item_of<N>(t, w, c);
    const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(x + it.small);
    const Codes<N> k = *reinterpret_cast<const Codes<N>*>(codes + it.small);
    Vec<T, N> o0, o1, o2, o3;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      o0.v[l] = k.v[l] == 0 ? v.v[l] : z;
      o1.v[l] = k.v[l] == 1 ? v.v[l] : z;
      o2.v[l] = k.v[l] == 2 ? v.v[l] : z;
      o3.v[l] = k.v[l] == 3 ? v.v[l] : z;
    }
    *reinterpret_cast<Vec<T, N>*>(out + it.big) = o0;
    *reinterpret_cast<Vec<T, N>*>(out + it.big + c) = o1;
    *reinterpret_cast<Vec<T, N>*>(out + it.big + down) = o2;
    *reinterpret_cast<Vec<T, N>*>(out + it.big + down + c) = o3;
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    gather_kernel(const T* __restrict__ g, const int8_t* __restrict__ codes,
                  T* __restrict__ out, int64_t rows, int64_t w, int64_t c) {
  const int64_t total = rows * w * (c / N);
  const int64_t down = 2 * w * c;
  for (int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       t < total; t += (int64_t)gridDim.x * blockDim.x) {
    const Item it = item_of<N>(t, w, c);
    const Codes<N> k = *reinterpret_cast<const Codes<N>*>(codes + it.small);
    const Vec<T, N> g0 = *reinterpret_cast<const Vec<T, N>*>(g + it.big);
    const Vec<T, N> g1 = *reinterpret_cast<const Vec<T, N>*>(g + it.big + c);
    const Vec<T, N> g2 =
        *reinterpret_cast<const Vec<T, N>*>(g + it.big + down);
    const Vec<T, N> g3 =
        *reinterpret_cast<const Vec<T, N>*>(g + it.big + down + c);
    Vec<T, N> o;
#pragma unroll
    for (int l = 0; l < N; ++l) {
      // the TPU kernel's nesting: 0, 1, 2, anything else -> (1, 1)
      o.v[l] = k.v[l] == 0   ? g0.v[l]
               : k.v[l] == 1 ? g1.v[l]
               : k.v[l] == 2 ? g2.v[l]
                             : g3.v[l];
    }
    *reinterpret_cast<Vec<T, N>*>(out + it.small) = o;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

int blocks_for(int64_t total) {
  int64_t b = (total + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<int>(b < 1 ? 1 : b);
}

enum class Op { kPool, kScatter, kGather };

// a: the kernel's first tensor argument, b: its second, o: its third
// (pool: x, pooled, codes; scatter: x, codes, out; gather: g, codes, out)
template <typename T, int N>
void launch_n(Op op, const void* a, void* b, void* o, int64_t rows,
              int64_t w, int64_t c, cudaStream_t s) {
  const int grid = blocks_for(rows * w * (c / N));
  switch (op) {
    case Op::kPool:
      pool_kernel<T, N><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(a), static_cast<T*>(b),
          static_cast<int8_t*>(o), rows, w, c);
      break;
    case Op::kScatter:
      scatter_kernel<T, N><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(a), static_cast<const int8_t*>(b),
          static_cast<T*>(o), rows, w, c);
      break;
    case Op::kGather:
      gather_kernel<T, N><<<grid, kThreads, 0, s>>>(
          static_cast<const T*>(a), static_cast<const int8_t*>(b),
          static_cast<T*>(o), rows, w, c);
      break;
  }
}

// The 16-byte vector path when C and every pointer allow it, else the
// scalar path.  `codes` is the int8 tensor among a, b, o.
template <typename T>
int launch(Op op, const void* a, void* b, void* o, const void* codes,
           const void* v0, const void* v1, int64_t rows, int64_t w,
           int64_t c, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c % kVec == 0 && aligned(v0, 16) && aligned(v1, 16) &&
      aligned(codes, kVec)) {
    launch_n<T, kVec>(op, a, b, o, rows, w, c, s);
  } else {
    launch_n<T, 1>(op, a, b, o, rows, w, c, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Op op, const void* a, void* b, void* o, const void* codes,
             const void* v0, const void* v1, int64_t rows, int64_t w,
             int64_t c, int dtype, void* stream) {
  if (rows <= 0 || w <= 0 || c <= 0) return 0;
  if (dtype == kF32)
    return launch<float>(op, a, b, o, codes, v0, v1, rows, w, c, stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(op, a, b, o, codes, v0, v1, rows, w, c,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x (rows*2, 2w, C) -> pooled (rows, w, C), codes (rows, w, C) int8;
// rows = N * h of the pooled tensor.
extern "C" int spalign_pool2x2(const void* x, void* pooled, void* codes,
                               int64_t rows, int64_t w, int64_t c,
                               int dtype, void* stream) {
  return dispatch(Op::kPool, x, pooled, codes, codes, x, pooled, rows, w, c,
                  dtype, stream);
}

// x (rows, w, C) + codes -> out (rows*2, 2w, C)
extern "C" int spalign_scatter2x2(const void* x, const void* codes, void* out,
                                  int64_t rows, int64_t w, int64_t c,
                                  int dtype, void* stream) {
  return dispatch(Op::kScatter, x, const_cast<void*>(codes), out, codes, x,
                  out, rows, w, c, dtype, stream);
}

// g (rows*2, 2w, C) + codes (rows, w, C) -> out (rows, w, C)
extern "C" int spalign_gather2x2(const void* g, const void* codes, void* out,
                                 int64_t rows, int64_t w, int64_t c,
                                 int dtype, void* stream) {
  return dispatch(Op::kGather, g, const_cast<void*>(codes), out, codes, g,
                  out, rows, w, c, dtype, stream);
}
