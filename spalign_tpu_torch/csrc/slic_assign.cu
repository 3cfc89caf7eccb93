// One SLIC assignment step for Hopper (sm_90a), a batch of images per
// launch, with the next centre update's sums fused into the same pass.
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
// centers_from_sums) equals one sweep of the Lloyd kernel bit for bit.
//
// Outputs, either or both: labels (B, HW) int32, and sums (B, K, 6) int64,
// zeroed by the caller, to which the launch adds each centre's members'
// round(L * 2^16), round(a * 2^16), round(b * 2^16), y, x and count.  The
// n_iter updating sweeps of the per-sweep engine ask for the sums only, so
// they read 12 bytes a pixel and write no labels; the final sweep asks for
// the labels only.  Integer sums do not depend on the order of the
// atomics, so they equal the plain version's (bincount over float64, exact
// below 2^53) bit for bit.  64 bits even for y and x: a full-resolution
// frame's coordinate sums pass 2^31.
//
// Layout.  lab is planar (B, 3, HW) float32: the lanes of a warp read 32
// neighbouring pixels of one tile row from each plane, and y, x, y*r, x*r
// are computed from the pixel's position (12 bytes a pixel).  centers is
// (B, K, 5) float32 rows L, a, b, y, x with K <= 1024.
//
// Design.  The grid is (tiles, B): one block of 256 threads per 32 x 32
// tile of one image (slic_tile.cuh), the ragged edge masked.  The block
// stages the image's K centres in shared memory (32 bytes a centre, as two
// float4 rows); each warp then scans its strip of 4 rows against the
// strip's candidate centres only (slic_tile.cuh: ~18 of the 98 centres of
// a full-resolution frame), each lane its 4 pixels of one column at once.
// This replaces the all-K window test of one thread per pixel.  The sums:
// lanes of a warp-row that chose the same centre are summed first
// (__reduce_add_sync) into the registers of the lane that owns the
// centre's slot; at the end of the strip each such lane adds its sums to
// the block's per-centre sums in shared memory (32-bit atomics, L, a, b
// as carried lo/hi pairs), and at the end of the block one 64-bit global
// atomicAdd per non-empty centre and field carries them out.  The 2,940
// sums of a 30-frame batch see little contention: a centre's members span
// ~30 blocks.  Per-tile partials reduced in a second launch were not
// needed.
//
// What bounds it on this card.  Bytes: 12 read a pixel, plus 4 written
// when the labels are asked for, against ~10 float32 operations for each
// of the ~13 centres in a pixel's window.  Above that bound is what the
// bound does not count: the exact window test of the candidates outside a
// pixel's window, the score's unfused float32 operations one instruction
// each, and, with the sums, the warp reductions of each warp-row's groups
// (measured: they cost more than the atomics; PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slic_tile.cuh"

namespace {

using slic::kThreads;
using slic::kTileH;

constexpr int kMaxCenters = 1024;
constexpr int kMaxSide = 1 << 20;  // a block's y and x sums fit 32 bits
constexpr int kFields = 6;         // L, a, b (fixed point), y, x, count
constexpr int kWords = 9;          // L, a, b as lo/hi pairs; y, x, count

// dynamic shared memory: [pos, feat: the K centres, float4 each] [acc:
// 9 x K u32, the block's sums per centre, only with sums]
size_t shared_bytes(int n_centers, bool with_sums) {
  return 2 * sizeof(float4) * n_centers +
         (with_sums ? sizeof(unsigned) * kWords * n_centers : 0);
}

__device__ __forceinline__ void add_global(long long* dst, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst),
            (unsigned long long)v);
}

__global__ void __launch_bounds__(kThreads)
slic_assign_kernel(const float* __restrict__ lab,
                   const float* __restrict__ centers,
                   int32_t* __restrict__ labels, long long* __restrict__ sums,
                   int height, int width, int n_centers, float ratio,
                   float window, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_k = n_centers;
  float4* pos = reinterpret_cast<float4*>(smem);
  float4* feat = pos + n_k;
  unsigned* acc = reinterpret_cast<unsigned*>(feat + n_k);

  const int img = blockIdx.y;
  const int hw = height * width;
  const int tid = threadIdx.x;
  const float* cimg = centers + (size_t)img * n_k * 5;
  for (int k = tid; k < n_k; k += kThreads) {
    const float* c = cimg + (size_t)k * 5;
    slic::set_center(c[0], c[1], c[2], c[3], c[4], ratio, &pos[k],
                     &feat[k]);
  }
  if (sums != nullptr) {
    for (int i = tid; i < kWords * n_k; i += kThreads) acc[i] = 0u;
  }
  __syncthreads();

  const int y0 =
      (blockIdx.x / tiles_x) * kTileH + (tid >> 5) * slic::kStripRows;
  const int x0 = (blockIdx.x % tiles_x) * slic::kTileW;
  const float* p_l = lab + (size_t)img * 3 * hw;
  int32_t* out = labels != nullptr ? labels + (size_t)img * hw : nullptr;
  if (sums == nullptr) {
    auto none = [](int, const slic::Sums&) {};
    slic::scan_strip<false>(pos, feat, n_k, p_l, hw, height, width, y0, x0,
                            ratio, window, out, none, none);
    return;
  }
  // a strip's slot sums go to the block's per-centre sums in shared
  // memory; a centre without a register slot goes to the global sums
  long long* img_sums = sums + (size_t)img * n_k * kFields;
  auto flush = [&](int k, const slic::Sums& g) {
    slic::add_split(&acc[k], &acc[n_k + k], g.l);
    slic::add_split(&acc[2 * n_k + k], &acc[3 * n_k + k], g.a);
    slic::add_split(&acc[4 * n_k + k], &acc[5 * n_k + k], g.b);
    atomicAdd(&acc[6 * n_k + k], g.y);
    atomicAdd(&acc[7 * n_k + k], g.x);
    atomicAdd(&acc[8 * n_k + k], g.n);
  };
  auto spill = [&](int k, const slic::Sums& g) {
    long long* dst = img_sums + (size_t)k * kFields;
    add_global(dst, g.l); add_global(dst + 1, g.a);
    add_global(dst + 2, g.b); add_global(dst + 3, g.y);
    add_global(dst + 4, g.x); add_global(dst + 5, g.n);
  };
  slic::scan_strip<true>(pos, feat, n_k, p_l, hw, height, width, y0, x0,
                         ratio, window, out, spill, flush);
  __syncthreads();
  for (int k = tid; k < n_k; k += kThreads) {
    if (acc[8 * n_k + k] == 0u) continue;
    long long* dst = img_sums + (size_t)k * kFields;
    add_global(dst, slic::join_split(acc[k], acc[n_k + k]));
    add_global(dst + 1, slic::join_split(acc[2 * n_k + k], acc[3 * n_k + k]));
    add_global(dst + 2, slic::join_split(acc[4 * n_k + k], acc[5 * n_k + k]));
    add_global(dst + 3, acc[6 * n_k + k]);
    add_global(dst + 4, acc[7 * n_k + k]);
    add_global(dst + 5, acc[8 * n_k + k]);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  labels or sums
// may be null, not both; sums must be zeroed.  Height and width at most
// 2^20.  Allocates nothing; returns cudaGetLastError() after the launch (0
// on success).
extern "C" int spalign_slic_assign(const float* lab, const float* centers,
                                   int32_t* labels, long long* sums,
                                   int n_images, int height, int width,
                                   int n_centers, float ratio, float window,
                                   void* stream) {
  if (n_images <= 0 || n_images > 65535 || height <= 0 || width <= 0 ||
      height > kMaxSide || width > kMaxSide || n_centers <= 0 ||
      n_centers > kMaxCenters || (long long)height * width > 0x7fffffffLL ||
      (labels == nullptr && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (width + slic::kTileW - 1) / slic::kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const size_t shared = shared_bytes(n_centers, sums != nullptr);
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slic_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(tiles_x * tiles_y, n_images);
  slic_assign_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      lab, centers, labels, sums, height, width, n_centers, ratio, window,
      tiles_x);
  return (int)cudaGetLastError();
}
