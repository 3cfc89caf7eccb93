// One SLIC assignment step for Hopper (sm_90a), a batch of images per launch.
//
// Replaces the TPU kernel
// spalign_tpu/kernels/experimental/slic_pallas.py::_assign_kernel (reached
// through slic_assign_pallas).  Same function, in the arithmetic of
// csrc/slic_lloyd.cu:
//   * each pixel takes the argmax over centres of the score
//       p.c - |c|^2 / 2   over the features L, a, b, y*r, x*r
//     (the argmin of the TPU kernel's squared distance, up to rounding),
//     among the centres whose raw (y, x) lie within the Chebyshev window
//     |py - cy| <= window && |px - cx| <= window;
//   * the lowest centre id wins ties; when no centre is in the window the
//     pixel takes the unmasked argmax.
// The score and |c|^2/2 use float32 operations without contraction
// (__fmul_rn, __fadd_rn) in the order of slic_lloyd.cu and of the plain
// PyTorch version, so one sweep of the per-sweep engine (this kernel plus
// the shared fixed-point centre update) equals one sweep of the Lloyd
// kernel bit for bit.
//
// Layout.  lab is planar (B, 3, HW) float32, as for slic_lloyd.cu: thread t
// of a block reads element p of each plane, so a warp loads 128 contiguous
// bytes per plane, and y, x, y*r, x*r are computed from p instead of being
// read (12 bytes a pixel; the TPU kernel read 32-byte packed rows padded to
// 2,048-pixel tiles, with filler pixels and -1e9 pad centres for Mosaic's
// (8, 128) tiling -- none of that is carried over: the kernel masks the
// ragged last block itself).  centers is (B, K, 5) float32 rows
// L, a, b, y, x with K <= 1024; labels (B, HW) int32.
//
// Design (simple, right first).  The grid is (ceil(HW / 256), B): one thread
// per pixel, so any HW and any batch fill the card.  Each block stages its
// image's K centres in dynamic shared memory -- raw y and x for the window
// test, L, a, b, y*r, x*r and |c|^2/2 for the score, 32 bytes a centre, at
// most 32 KB -- and each thread scans all K with the window test, scoring
// only the centres in its window.
//
// What bounds it on this card.  The least work is bytes: 12 bytes read and
// 4 written a pixel against ~10 float32 operations for each of the ~9-16
// centres in the window.  This first design spends most of its instructions
// on the window test over all K centres, which the bound does not count.
// Later work, a redesign: scan only the 5 x 5 neighbouring grid cells'
// centres, and fuse the centre sums of the next update into this pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCenters = 1024;
constexpr int kThreads = 256;
constexpr int kCenterFloats = 8;  // y, x, L, a, b, y*r, x*r, |c|^2/2

// f32 score p.c - |c|^2/2 in a fixed order, each operation rounded
__device__ __forceinline__ float score(float cl, float ca, float cb,
                                       float cyr, float cxr, float chalf,
                                       float l, float a, float b, float yr,
                                       float xr) {
  float s = __fadd_rn(__fmul_rn(cl, l), __fmul_rn(ca, a));
  s = __fadd_rn(s, __fmul_rn(cb, b));
  s = __fadd_rn(s, __fmul_rn(cyr, yr));
  s = __fadd_rn(s, __fmul_rn(cxr, xr));
  return __fsub_rn(s, chalf);
}

__device__ __forceinline__ float half_norm2(float l, float a, float b,
                                            float yr, float xr) {
  float s = __fadd_rn(__fmul_rn(l, l), __fmul_rn(a, a));
  s = __fadd_rn(s, __fmul_rn(b, b));
  s = __fadd_rn(s, __fmul_rn(yr, yr));
  s = __fadd_rn(s, __fmul_rn(xr, xr));
  return __fmul_rn(0.5f, s);
}

__global__ void __launch_bounds__(kThreads)
slic_assign_kernel(const float* __restrict__ lab,
                   const float* __restrict__ centers,
                   int32_t* __restrict__ labels, int height, int width,
                   int n_centers, float ratio, float window) {
  extern __shared__ float smem[];
  float* c_y = smem;
  float* c_x = c_y + n_centers;
  float* c_l = c_x + n_centers;
  float* c_a = c_l + n_centers;
  float* c_b = c_a + n_centers;
  float* c_yr = c_b + n_centers;
  float* c_xr = c_yr + n_centers;
  float* c_half = c_xr + n_centers;

  const int img = blockIdx.y;
  const int hw = height * width;
  const float* cimg = centers + (size_t)img * n_centers * 5;
  for (int k = threadIdx.x; k < n_centers; k += kThreads) {
    const float* c = cimg + (size_t)k * 5;
    const float l = c[0], a = c[1], b = c[2], y = c[3], x = c[4];
    const float yr = __fmul_rn(y, ratio), xr = __fmul_rn(x, ratio);
    c_y[k] = y; c_x[k] = x;
    c_l[k] = l; c_a[k] = a; c_b[k] = b;
    c_yr[k] = yr; c_xr[k] = xr;
    c_half[k] = half_norm2(l, a, b, yr, xr);
  }
  __syncthreads();

  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;  // the ragged last block
  const float* p_l = lab + (size_t)img * 3 * hw;
  const float l = p_l[p], a = p_l[hw + p], b = p_l[2 * hw + p];
  const int py = p / width;
  const int px = p - py * width;
  const float fy = (float)py, fx = (float)px;
  const float yr = __fmul_rn(fy, ratio), xr = __fmul_rn(fx, ratio);
  int best = -1;
  float best_s = -INFINITY;
  for (int k = 0; k < n_centers; ++k) {
    if (fabsf(fy - c_y[k]) <= window && fabsf(fx - c_x[k]) <= window) {
      const float s = score(c_l[k], c_a[k], c_b[k], c_yr[k], c_xr[k],
                            c_half[k], l, a, b, yr, xr);
      if (s > best_s) { best_s = s; best = k; }
    }
  }
  if (best < 0) {  // empty window: unmasked argmax
    for (int k = 0; k < n_centers; ++k) {
      const float s = score(c_l[k], c_a[k], c_b[k], c_yr[k], c_xr[k],
                            c_half[k], l, a, b, yr, xr);
      if (s > best_s) { best_s = s; best = k; }
    }
  }
  labels[(size_t)img * hw + p] = best;
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Allocates
// nothing; returns cudaGetLastError() after the launch (0 on success).
extern "C" int spalign_slic_assign(const float* lab, const float* centers,
                                   int32_t* labels, int n_images, int height,
                                   int width, int n_centers, float ratio,
                                   float window, void* stream) {
  if (n_images <= 0 || n_images > 65535 || height <= 0 || width <= 0 ||
      n_centers <= 0 || n_centers > kMaxCenters ||
      (long long)height * width > 0x7fffffffLL - kThreads)
    return (int)cudaErrorInvalidValue;
  const int hw = height * width;
  const dim3 grid((hw + kThreads - 1) / kThreads, n_images);
  const size_t shared = sizeof(float) * kCenterFloats * n_centers;
  slic_assign_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      lab, centers, labels, height, width, n_centers, ratio, window);
  return (int)cudaGetLastError();
}
