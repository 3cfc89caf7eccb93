// SLIC Lloyd loop for Hopper (sm_90a), a batch of images per launch, each
// image on a thread-block cluster.
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
// Layout.  lab is planar (B, 3, HW) float32: the lanes of a warp read 32
// neighbouring pixels of one tile row from each plane, and the pixel's y,
// x, y*r, x*r are computed from its position instead of being read (12
// bytes a pixel instead of the TPU kernel's 32).  c0 is (B, K, 5) float32
// rows L, a, b, y, x; labels (B, HW) int32.
//
// Design.  One image runs on a thread-block cluster of C CTAs of 256
// threads (launched with cudaLaunchKernelEx and a cluster-dimension
// attribute).  Every CTA holds all K <= 128 centres in shared memory.  In
// each sweep CTA r takes the tiles r, r + C, r + 2C, ... of the image (32
// x 32 pixels, slic_tile.cuh), and each of its warps scans its strip of 4
// rows of a tile against the candidates from the centres' current
// positions (slic_tile.cuh: ~23 of 100 centres for a 4 x 32 strip of a
// 224^2 image), with no barrier between tiles.  The members' sums go to
// the CTA's shared memory.  After the sweep, cluster.sync(); then CTA r
// reduces the centres k = r (mod C) over its peers' shared sums through
// distributed shared memory (cluster.map_shared_rank), computes their new
// positions and writes them into every peer's centre rows; a second
// cluster.sync() and the next sweep begins.  C is the largest of 16, 8,
// 4, 2 that is at most the image's tile count and with which all B
// clusters fit on the card at once (cudaOccupancyMaxActiveClusters),
// else 1; PERF.md has the values at the two shapes the label paths run.
//
// Exactness.  Every sum is an integer, so the result does not depend on
// the order in which threads and CTAs add: y, x and the counts are exact,
// and L, a, b are summed as fixed-point values round(v * 2^16) in 64 bits
// (a centre mean is then within 2^-17 of the exact mean, closer than a
// float32 sum gets).  The score and the centre update use float32
// operations without contraction (__fmul_rn, __fadd_rn) and float64 means,
// in the order the plain PyTorch version uses, so the kernel and its plain
// version give the same labels bit for bit.  Fixed point needs |L|, |a|,
// |b| < 1024, which CIELAB of sRGB satisfies; the 32-bit coordinate sums
// need H*W*max(H, W) < 2^32, which the wrapper checks.
//
// What bounds it on this card.  Per pixel and sweep the work is the score
// of the ~9-16 centres in the window: non-tensor float32 and integer
// operations, far above the 12 bytes a pixel the kernel reads (operations
// bound; see PERF.md for the count).  Above the bound: the score's
// unfused operations one instruction each, the exact window test of the
// candidates outside a pixel's window, the warp reductions of the sums,
// and at 150 images of 224^2 few CTAs a SM (C = 2).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slic_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using slic::kThreads;
using slic::kTileH;

constexpr int kMaxCenters = 128;
constexpr int kMaxCluster = 16;
constexpr int kWords = 9;  // L, a, b as lo/hi pairs; y, x, count

__global__ void __launch_bounds__(kThreads)
slic_lloyd_kernel(const float* __restrict__ lab,
                  const float* __restrict__ c0,
                  int32_t* __restrict__ labels, int height, int width,
                  int n_centers, int n_iter, float ratio, float window) {
  // the centres: (y, x, L, a) and (b, y*r, x*r, |c|^2/2) rows
  __shared__ float4 pos[kMaxCenters], feat[kMaxCenters];
  // this CTA's member sums: fixed-point L, a, b as lo/hi words; integer
  // y, x, count (an image's coordinate sums fit 32 bits)
  __shared__ unsigned acc[kWords][kMaxCenters];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned n_ctas = cluster.num_blocks();
  const int img = blockIdx.x / n_ctas;
  const int hw = height * width;
  const float* p_l = lab + (size_t)img * 3 * hw;
  int32_t* out = labels + (size_t)img * hw;
  const int tid = threadIdx.x;
  const int tiles_x = (width + slic::kTileW - 1) / slic::kTileW;
  const int n_tiles = tiles_x * ((height + kTileH - 1) / kTileH);

  if (tid < n_centers) {
    const float* c = c0 + ((size_t)img * n_centers + tid) * 5;
    slic::set_center(c[0], c[1], c[2], c[3], c[4], ratio, &pos[tid],
                     &feat[tid]);
  }
  auto add = [&](int k, const slic::Sums& g) {
    slic::add_split(&acc[0][k], &acc[1][k], g.l);
    slic::add_split(&acc[2][k], &acc[3][k], g.a);
    slic::add_split(&acc[4][k], &acc[5][k], g.b);
    atomicAdd(&acc[6][k], g.y);
    atomicAdd(&acc[7][k], g.x);
    atomicAdd(&acc[8][k], g.n);
  };

  for (int it = 0; it <= n_iter; ++it) {
    const bool update = it < n_iter;
    if (update && tid < n_centers) {
      for (int f = 0; f < kWords; ++f) acc[f][tid] = 0u;
    }
    __syncthreads();

    // each warp scans its strip of each of this CTA's tiles; the warps
    // share nothing but the centres, which stay fixed within a sweep
    for (int t = rank; t < n_tiles; t += n_ctas) {
      const int y0 = (t / tiles_x) * kTileH + (tid >> 5) * slic::kStripRows;
      const int x0 = (t % tiles_x) * slic::kTileW;
      if (update) {
        slic::scan_strip<true>(pos, feat, n_centers, p_l, hw, height, width,
                               y0, x0, ratio, window, nullptr, add, add);
      } else {
        slic::scan_strip<false>(pos, feat, n_centers, p_l, hw, height,
                                width, y0, x0, ratio, window, out, add, add);
      }
    }
    if (!update) break;

    // the cluster's sums are complete; CTA r updates centres k = r mod C
    cluster.sync();
    for (int k = rank + n_ctas * tid; k < n_centers;
         k += n_ctas * kThreads) {
      long long l = 0, a = 0, b = 0;
      unsigned long long y = 0, x = 0, n = 0;
      for (unsigned r = 0; r < n_ctas; ++r) {
        const unsigned* peer = cluster.map_shared_rank(&acc[0][0], r) + k;
        constexpr int f = kMaxCenters;  // stride of a field
        l += slic::join_split(peer[0], peer[f]);
        a += slic::join_split(peer[2 * f], peer[3 * f]);
        b += slic::join_split(peer[4 * f], peer[5 * f]);
        y += peer[6 * f];
        x += peer[7 * f];
        n += peer[8 * f];
      }
      if (n == 0ull) continue;  // empty centres keep their position
      const double dn = (double)n;
      float4 new_pos, new_feat;
      slic::set_center((float)((double)l / dn / 65536.0),
                       (float)((double)a / dn / 65536.0),
                       (float)((double)b / dn / 65536.0),
                       (float)((double)y / dn), (float)((double)x / dn),
                       ratio, &new_pos, &new_feat);
      for (unsigned r = 0; r < n_ctas; ++r) {
        cluster.map_shared_rank(pos, r)[k] = new_pos;
        cluster.map_shared_rank(feat, r)[k] = new_feat;
      }
    }
    // every peer's centres are written, and every peer is done reading
    // this CTA's sums before the next sweep zeroes them
    cluster.sync();
  }
}

cudaLaunchConfig_t launch_config(int n_images, int cluster,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_images * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t allow_large_clusters() {
  return cudaFuncSetAttribute(slic_lloyd_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              1);
}

}  // namespace

// CTAs per image (the cluster size C) for a launch over n_images images of
// height x width; a negative CUDA error code on failure.
extern "C" int spalign_slic_lloyd_cluster(int n_images, int height,
                                          int width) {
  if (n_images <= 0 || height <= 0 || width <= 0)
    return -(int)cudaErrorInvalidValue;
  const cudaError_t err = allow_large_clusters();
  if (err != cudaSuccess) return -(int)err;
  const long long n_tiles =
      (long long)((width + slic::kTileW - 1) / slic::kTileW) *
      ((height + kTileH - 1) / kTileH);
  for (int c = kMaxCluster; c > 1; c /= 2) {
    if (c > n_tiles) continue;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        launch_config(n_images, c, nullptr, &attr);
    int fits = 0;
    if (cudaOccupancyMaxActiveClusters(&fits, slic_lloyd_kernel, &cfg) !=
        cudaSuccess) {
      cudaGetLastError();  // this size is refused: clear it, try the next
      continue;
    }
    if (fits >= n_images) return c;
  }
  return 1;
}

// Launch on `stream` (a cudaStream_t passed as a pointer) with clusters of
// `cluster` CTAs (1..16, from spalign_slic_lloyd_cluster).  Allocates
// nothing; returns cudaGetLastError() after the launch (0 on success).
extern "C" int spalign_slic_lloyd(const float* lab, const float* c0,
                                  int32_t* labels, int n_images, int height,
                                  int width, int n_centers, int n_iter,
                                  float ratio, float window, int cluster,
                                  void* stream) {
  if (n_images <= 0 || height <= 0 || width <= 0 || n_centers <= 0 ||
      n_centers > kMaxCenters || n_iter < 0 || cluster < 1 ||
      cluster > kMaxCluster || (long long)n_images * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_large_clusters();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(n_images, cluster, (cudaStream_t)stream, &attr);
  const cudaError_t launched = cudaLaunchKernelEx(
      &cfg, slic_lloyd_kernel, lab, c0, labels, height, width, n_centers,
      n_iter, ratio, window);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}
