// SLIC Lloyd loop for Hopper (sm_90a), a batch of images per launch.
//
// Replaces the TPU kernel spalign_tpu/kernels/slic_fused.py::_lloyd_kernel
// (reached through slic_lloyd_fused).  Same function:
//   * each pixel takes the argmax over centres of the score
//       p.c - |c|^2 / 2   over the features L, a, b, y*r, x*r,
//     among the centres whose raw (y, x) lie within the Chebyshev window
//     |py - cy| <= window && |px - cx| <= window  (k < K);
//     the lowest centre id wins ties; when no centre is in the window
//     the pixel takes the unmasked argmax;
//   * each centre moves to the mean of its members (cnt > 0 ? sum/cnt :
//     old position);
//   * n_iter updates, then one final assignment, whose labels are the
//     only output.
//
// Layout.  lab is planar (B, 3, HW) float32: thread t of a block reads
// element p = base + t of each plane, so a warp loads 128 contiguous bytes
// per plane (coalesced), and the pixel's y, x, y*r, x*r are computed from
// p instead of being read (12 bytes a pixel instead of the TPU kernel's 32).
// c0 is (B, K, 5) float32 rows L, a, b, y, x; labels (B, HW) int32.
//
// Design (simple, right first).  One thread block per image: the centres
// (8 x 128 floats) and the sweep's sums live in shared memory, and the
// block's threads stride over the image's pixels, each scanning all K
// centres.  Every sum is an integer, so the result does not depend on the
// order in which threads add: y, x and the counts are exact, and L, a, b
// are summed as fixed-point values round(v * 2^16) in 64 bits (a centre
// mean is then within 2^-17 of the exact mean, closer than a float32 sum
// gets).  Lanes of a warp that chose the same centre are summed first
// (one __reduce_add_sync per feature), so the shared atomics see one add
// per centre and warp instead of 32.  The score and the centre update
// use float32 operations without contraction (__fmul_rn, __fadd_rn), in
// the order the plain PyTorch version uses, so the kernel and its plain
// version give the same labels bit for bit.  Fixed point needs
// |L|, |a|, |b| < 1024, which CIELAB of sRGB satisfies.
//
// What bounds it on this card.  Per pixel and sweep the work is the
// window test against K centres plus the score of the ~9-16 centres in
// the window: non-tensor float32 and integer operations, far above the
// 12 bytes a pixel the kernel reads (operations bound; see PERF.md for
// the count).  This design spends most of its instructions on the window
// test over all K, and at the bench unit (B = 150 images) one block per
// image fills the 132 SMs only about once.
//
// Later work, a redesign and not part of this kernel: split one image
// across a thread-block cluster (distributed shared memory for the sums)
// so that a 30-image batch fills the card, and scan only the windowed
// candidates (the 5 x 5 neighbouring grid cells) instead of all K.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxCenters = 128;
constexpr int kThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kFixedScale = 65536.f;  // 2^16: L, a, b fixed point

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
slic_lloyd_kernel(const float* __restrict__ lab,
                  const float* __restrict__ c0,
                  int32_t* __restrict__ labels, int height, int width,
                  int n_centers, int n_iter, float ratio, float window) {
  // centres: raw (y, x) for the window test; L, a, b, y*r, x*r, |c|^2/2
  __shared__ float2 c_yx[kMaxCenters];
  __shared__ float c_l[kMaxCenters], c_a[kMaxCenters], c_b[kMaxCenters];
  __shared__ float c_yr[kMaxCenters], c_xr[kMaxCenters];
  __shared__ float c_half[kMaxCenters];
  // the sweep's member sums: fixed-point L, a, b; integer y, x, count
  __shared__ unsigned long long s_l[kMaxCenters], s_a[kMaxCenters],
      s_b[kMaxCenters];
  __shared__ unsigned s_y[kMaxCenters], s_x[kMaxCenters];
  __shared__ unsigned s_n[kMaxCenters];

  const int img = blockIdx.x;
  const int hw = height * width;
  const float* p_l = lab + (size_t)img * 3 * hw;
  const float* p_a = p_l + hw;
  const float* p_b = p_a + hw;
  int32_t* out = labels + (size_t)img * hw;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid < n_centers) {
    const float* c = c0 + ((size_t)img * n_centers + tid) * 5;
    const float l = c[0], a = c[1], b = c[2], y = c[3], x = c[4];
    const float yr = __fmul_rn(y, ratio), xr = __fmul_rn(x, ratio);
    c_l[tid] = l; c_a[tid] = a; c_b[tid] = b;
    c_yx[tid] = make_float2(y, x); c_yr[tid] = yr; c_xr[tid] = xr;
    c_half[tid] = half_norm2(l, a, b, yr, xr);
  }

  for (int it = 0; it <= n_iter; ++it) {
    const bool update = it < n_iter;
    if (update && tid < n_centers) {
      s_l[tid] = 0ull; s_a[tid] = 0ull; s_b[tid] = 0ull;
      s_y[tid] = 0u; s_x[tid] = 0u; s_n[tid] = 0u;
    }
    __syncthreads();

    // the trip count is uniform across the block, so every lane of every
    // warp reaches the warp collectives below
    for (int base = 0; base < hw; base += kThreads) {
      const int p = base + tid;
      int best = -1;
      float l = 0.f, a = 0.f, b = 0.f;
      int py = 0, px = 0;
      if (p < hw) {
        l = p_l[p]; a = p_a[p]; b = p_b[p];
        py = p / width;
        px = p - py * width;
        const float fy = (float)py, fx = (float)px;
        const float yr = __fmul_rn(fy, ratio), xr = __fmul_rn(fx, ratio);
        float best_s = -INFINITY;
        for (int k = 0; k < n_centers; ++k) {
          const float2 c = c_yx[k];
          if (fabsf(fy - c.x) <= window && fabsf(fx - c.y) <= window) {
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
        if (!update) out[p] = best;
      }
      if (update) {
        const int q_l = __float2int_rn(l * kFixedScale);
        const int q_a = __float2int_rn(a * kFixedScale);
        const int q_b = __float2int_rn(b * kFixedScale);
        // one group per distinct centre among the warp's lanes
        unsigned pending = __ballot_sync(kFullMask, best >= 0);
        while (pending) {
          const int leader = __ffs(pending) - 1;
          const int k = __shfl_sync(kFullMask, best, leader);
          const bool mine = best == k;
          const unsigned group = __ballot_sync(kFullMask, mine);
          const int g_l = __reduce_add_sync(kFullMask, mine ? q_l : 0);
          const int g_a = __reduce_add_sync(kFullMask, mine ? q_a : 0);
          const int g_b = __reduce_add_sync(kFullMask, mine ? q_b : 0);
          const unsigned g_y = __reduce_add_sync(kFullMask,
                                                 mine ? (unsigned)py : 0u);
          const unsigned g_x = __reduce_add_sync(kFullMask,
                                                 mine ? (unsigned)px : 0u);
          if (lane == leader) {
            atomicAdd(&s_l[k], (unsigned long long)(long long)g_l);
            atomicAdd(&s_a[k], (unsigned long long)(long long)g_a);
            atomicAdd(&s_b[k], (unsigned long long)(long long)g_b);
            atomicAdd(&s_y[k], g_y);
            atomicAdd(&s_x[k], g_x);
            atomicAdd(&s_n[k], (unsigned)__popc(group));
          }
          pending &= ~group;
        }
      }
    }
    __syncthreads();

    if (update && tid < n_centers) {
      const unsigned n = s_n[tid];
      if (n > 0u) {  // empty centres keep their position
        const double dn = (double)n;
        const float l = (float)((double)(long long)s_l[tid] / dn / 65536.0);
        const float a = (float)((double)(long long)s_a[tid] / dn / 65536.0);
        const float b = (float)((double)(long long)s_b[tid] / dn / 65536.0);
        const float y = (float)((double)s_y[tid] / dn);
        const float x = (float)((double)s_x[tid] / dn);
        const float yr = __fmul_rn(y, ratio), xr = __fmul_rn(x, ratio);
        c_l[tid] = l; c_a[tid] = a; c_b[tid] = b;
        c_yx[tid] = make_float2(y, x); c_yr[tid] = yr; c_xr[tid] = xr;
        c_half[tid] = half_norm2(l, a, b, yr, xr);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  Allocates
// nothing; returns cudaGetLastError() after the launch (0 on success).
extern "C" int spalign_slic_lloyd(const float* lab, const float* c0,
                                  int32_t* labels, int n_images, int height,
                                  int width, int n_centers, int n_iter,
                                  float ratio, float window, void* stream) {
  if (n_images <= 0 || height <= 0 || width <= 0 || n_centers <= 0 ||
      n_centers > kMaxCenters || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  slic_lloyd_kernel<<<n_images, kThreads, 0, (cudaStream_t)stream>>>(
      lab, c0, labels, height, width, n_centers, n_iter, ratio, window);
  return (int)cudaGetLastError();
}
