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
// (B, K, 5) float32 rows L, a, b, y, x, any K >= 1, as the TPU kernel
// takes any K.
//
// Design, one at every K.  The grid is (tiles, B): one block of 256
// threads per 32 x 32 tile of one image (slic_tile.cuh), the ragged edge
// masked.  The window is local (2 * step around a centre), so however
// large K grows, a tile's pixels see only the centres near it: a few dozen
// at the overlaps inputs (K = 98 on 1024x2048, K = 1,035 on 512x1024, K =
// 4,095 on 1024x2048: step ~22 px), ~440 at step 2 px.  So the block
// stages only those: its 256 threads test the image's K centres in device
// memory, 256 at a time, against the tile's row and column range widened
// by window + 1 (the strip filter's bounds over the whole tile, so a
// superset of each of its strips' candidates), and the survivors go to
// shared memory in increasing id order, with their ids (36 bytes each;
// the prefix sum of the warps' ballots keeps the order).  Each warp then
// scans its strip of 4 rows against the strip's candidates among the
// survivors (slic_tile.cuh), each lane its 4 pixels of one column at once:
// the same candidates in the same order as a strip filter over all K, so
// the same labels.  The one pixel case that needs every centre, an empty
// window, scans the K rows in device memory (GlobalCentres); it does not
// fire on a regular grid.
//
// The staging buffer holds kStageCap = 512 survivors, 36,864 bytes with
// the sums: within the 48 KB a block takes without opting in, and about
// what four 256-thread blocks of ~64 registers a thread leave of an SM's
// shared memory, so its size costs no occupancy and needs no query of the
// card's limit.  A tile with more survivors than that (centres packed far
// tighter than any grid: 512 survivors need a step below ~1.8 px) scans
// every centre from device memory instead, strip by strip, with its sums
// going straight to the global atomics: slower, the same labels and sums.
//
// The sums: lanes of a warp-row that chose the same centre are summed
// first (__reduce_add_sync) into the registers of the lane that owns the
// centre's slot; at the end of the strip each such lane adds its sums to
// the block's per-survivor sums in shared memory (32-bit atomics, L, a, b
// as carried lo/hi pairs), and at the end of the block one 64-bit global
// atomicAdd per non-empty survivor and field carries them out, to the
// survivor's global id.  A centre without a register slot is added to the
// global sums by its id at once.  The 2,940 sums of a 30-frame batch see
// little contention: a centre's members span ~30 blocks.
//
// What bounds it on this card.  Bytes: 12 read a pixel, plus 4 written
// when the labels are asked for, against ~10 float32 operations for each
// of the ~13 centres in a pixel's window.  Above that bound is what the
// bound does not count: the staging (K centres read by every block: 8 KB a
// tile at K = 1,035, from L2), the exact window test of the candidates
// outside a pixel's window, the score's unfused float32 operations one
// instruction each, and, with the sums, the warp reductions of each
// warp-row's groups (measured: they cost more than the atomics; PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "slic_tile.cuh"

namespace {

using slic::kThreads;
using slic::kTileH;
using slic::kTileW;

constexpr int kStageCap = 512;     // survivors a block stages at most
constexpr int kMaxSide = 1 << 20;  // a block's y and x sums fit 32 bits
constexpr int kFields = 6;         // L, a, b (fixed point), y, x, count
constexpr int kWords = 9;          // L, a, b as lo/hi pairs; y, x, count

// dynamic shared memory: [pos, feat: the staged survivors, float4 each]
// [ids: their centre ids] [acc: 9 x cap u32, the block's sums per
// survivor, only with sums]
size_t shared_bytes(int cap, bool with_sums) {
  return (2 * sizeof(float4) + sizeof(int)) * cap +
         (with_sums ? sizeof(unsigned) * kWords * cap : 0);
}

__device__ __forceinline__ void add_global(long long* dst, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst),
            (unsigned long long)v);
}

__global__ void __launch_bounds__(kThreads)
slic_assign_kernel(const float* __restrict__ lab,
                   const float* __restrict__ centers,
                   int32_t* __restrict__ labels, long long* __restrict__ sums,
                   int height, int width, int n_centers, int cap, float ratio,
                   float window, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_counts[slic::kWarps];
  float4* pos = reinterpret_cast<float4*>(smem);
  float4* feat = pos + cap;
  int* ids = reinterpret_cast<int*>(feat + cap);
  unsigned* acc = reinterpret_cast<unsigned*>(ids + cap);

  const int img = blockIdx.y;
  const int hw = height * width;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty0 = (blockIdx.x / tiles_x) * kTileH;
  const int x0 = (blockIdx.x % tiles_x) * kTileW;
  const float* cimg = centers + (size_t)img * n_centers * 5;

  // stage the tile's survivors in increasing id order: a round of 256
  // centres, each warp's ballot, the warps' counts summed in warp order
  const float pad = __fadd_rn(window, 1.f);
  const float lo_y = __fsub_rn((float)ty0, pad);
  const float hi_y = __fadd_rn((float)(min(ty0 + kTileH, height) - 1), pad);
  const float lo_x = __fsub_rn((float)x0, pad);
  const float hi_x = __fadd_rn((float)(min(x0 + kTileW, width) - 1), pad);
  int n_staged = 0;  // survivors so far, the same in every thread
  for (int base = 0; base < n_centers; base += kThreads) {
    const int k = base + tid;
    bool keep = false;
    if (k < n_centers) {
      const float cy = cimg[(size_t)k * 5 + 3], cx = cimg[(size_t)k * 5 + 4];
      keep = cy >= lo_y && cy <= hi_y && cx >= lo_x && cx <= hi_x;
    }
    const unsigned vote = __ballot_sync(slic::kFullMask, keep);
    if (lane == 0) warp_counts[warp] = __popc(vote);
    __syncthreads();
    int j = n_staged + __popc(vote & ((1u << lane) - 1u));
    for (int w = 0; w < slic::kWarps; ++w) {
      if (w < warp) j += warp_counts[w];
      n_staged += warp_counts[w];
    }
    if (keep && j < cap) {
      const float* c = cimg + (size_t)k * 5;
      slic::set_center(c[0], c[1], c[2], c[3], c[4], ratio, &pos[j],
                       &feat[j]);
      ids[j] = k;
    }
    __syncthreads();  // warp_counts is written again next round
  }
  const bool staged = n_staged <= cap;
  if (sums != nullptr && staged) {
    for (int i = tid; i < kWords * n_staged; i += kThreads) acc[i] = 0u;
  }
  __syncthreads();

  const int y0 = ty0 + warp * slic::kStripRows;
  const float* p_l = lab + (size_t)img * 3 * hw;
  int32_t* out = labels != nullptr ? labels + (size_t)img * hw : nullptr;
  const slic::GlobalCentres all = {cimg, n_centers, ratio};
  auto none = [](int, const slic::Sums&) {};
  long long* img_sums =
      sums != nullptr ? sums + (size_t)img * n_centers * kFields : nullptr;
  // a group's sums straight to the global sums of centre k
  auto spill = [&](int k, const slic::Sums& g) {
    long long* dst = img_sums + (size_t)k * kFields;
    add_global(dst, g.l); add_global(dst + 1, g.a);
    add_global(dst + 2, g.b); add_global(dst + 3, g.y);
    add_global(dst + 4, g.x); add_global(dst + 5, g.n);
  };
  if (!staged) {  // more survivors than the buffer: every centre, globally
    if (sums == nullptr)
      slic::scan_strip_over<false>(all, all, p_l, hw, height, width, y0, x0,
                                   ratio, window, out, none, none);
    else
      slic::scan_strip_over<true>(all, all, p_l, hw, height, width, y0, x0,
                                  ratio, window, out, spill, spill);
    return;
  }
  const slic::SharedCentres cand = {pos, feat, ids, n_staged};
  if (sums == nullptr) {
    slic::scan_strip_over<false>(cand, all, p_l, hw, height, width, y0, x0,
                                 ratio, window, out, none, none);
    return;
  }
  // a strip's slot sums go to the block's per-survivor sums in shared
  // memory (j: the survivor's index)
  const int n_s = n_staged;
  auto flush = [&](int j, const slic::Sums& g) {
    slic::add_split(&acc[j], &acc[n_s + j], g.l);
    slic::add_split(&acc[2 * n_s + j], &acc[3 * n_s + j], g.a);
    slic::add_split(&acc[4 * n_s + j], &acc[5 * n_s + j], g.b);
    atomicAdd(&acc[6 * n_s + j], g.y);
    atomicAdd(&acc[7 * n_s + j], g.x);
    atomicAdd(&acc[8 * n_s + j], g.n);
  };
  slic::scan_strip_over<true>(cand, all, p_l, hw, height, width, y0, x0,
                              ratio, window, out, spill, flush);
  __syncthreads();
  for (int j = tid; j < n_s; j += kThreads) {
    if (acc[8 * n_s + j] == 0u) continue;
    long long* dst = img_sums + (size_t)ids[j] * kFields;
    add_global(dst, slic::join_split(acc[j], acc[n_s + j]));
    add_global(dst + 1, slic::join_split(acc[2 * n_s + j], acc[3 * n_s + j]));
    add_global(dst + 2, slic::join_split(acc[4 * n_s + j], acc[5 * n_s + j]));
    add_global(dst + 3, acc[6 * n_s + j]);
    add_global(dst + 4, acc[7 * n_s + j]);
    add_global(dst + 5, acc[8 * n_s + j]);
  }
}

}  // namespace

// Launch on `stream` (a cudaStream_t passed as a pointer).  labels or sums
// may be null, not both; sums must be zeroed.  Height and width at most
// 2^20, any K >= 1.  Allocates nothing; returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int spalign_slic_assign(const float* lab, const float* centers,
                                   int32_t* labels, long long* sums,
                                   int n_images, int height, int width,
                                   int n_centers, float ratio, float window,
                                   void* stream) {
  if (n_images <= 0 || n_images > 65535 || height <= 0 || width <= 0 ||
      height > kMaxSide || width > kMaxSide || n_centers <= 0 ||
      (long long)height * width > 0x7fffffffLL ||
      (labels == nullptr && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles_x = (width + kTileW - 1) / kTileW;
  const int tiles_y = (height + kTileH - 1) / kTileH;
  const int cap = n_centers < kStageCap ? n_centers : kStageCap;
  const dim3 grid(tiles_x * tiles_y, n_images);
  slic_assign_kernel<<<grid, kThreads, shared_bytes(cap, sums != nullptr),
                       (cudaStream_t)stream>>>(
      lab, centers, labels, sums, height, width, n_centers, cap, ratio,
      window, tiles_x);
  return (int)cudaGetLastError();
}
