// Pieces shared by the two SLIC kernels (slic_lloyd.cu, slic_assign.cu):
// the centre rows in shared memory, the score in its fixed float32 order,
// and the scan of a warp's strip of pixels against its candidate centres,
// with the strip's centre sums kept in registers.
//
// Strips.  A block of 256 threads works on a 32 x 32 tile of pixels; its
// warp w takes the strip of R = 4 rows w*R .. w*R + R - 1, lane i the
// column i of each row.  A warp loads 128 contiguous bytes of a row from
// each plane, and a lane scans the candidates once for its R pixels, which
// share each candidate's loads and its column test.  The tile height is
// fixed here for both kernels: 32 rows were the fastest of 16, 32 and 64
// for the assignment kernel at the overlaps inputs and within 4% of the
// fastest for the Lloyd kernel at 224^2 (PERF.md).
//
// Centres.  The scan reads centres through a view (index j -> the two
// rows and the centre's id): SharedCentres, rows in shared memory with
// their ids in increasing order (the Lloyd kernel's K centres, or the
// assignment kernel's staged survivors of its tile), or GlobalCentres, an
// image's (K, 5) rows in device memory with each row's float4 pair
// computed on use in set_center's arithmetic, so that both views give the
// same floats.
//
// Candidates.  Before scoring, the warp tests the view's centres, 32 at a
// time (one per lane), against the strip's row and column range widened
// by window + 1; the ballot of each 32 is walked bit by bit, lowest first,
// so the survivors are scanned in increasing id order.  Each pixel runs
// the exact window test and the score on the survivors only, with s >
// best_s, so the lowest id wins ties.  The filter is conservative: a
// pixel accepts a centre when |fl(py - cy)| <= window, which needs the
// exact |py - cy| <= window (1 + 2^-23), and the strip's range widened by a
// whole pixel covers that with room to spare for the rounding of the
// bounds.  So the survivors are a superset of every pixel's window set:
// when none of them passes the exact test, the window is empty over all K,
// and only then does the pixel scan all K unmasked (through the second
// view, which holds all K).  The labels are those of the all-K scan.
// kernels/slic_assign.py::tile_candidates is the same filter in plain
// PyTorch, with the same float32 expressions.
//
// Sums.  The survivors of a strip are numbered in scan order (slots).  A
// warp-row's members are summed per group of lanes that chose the same
// centre (__reduce_add_sync, exact in 32 bits for |L|, |a|, |b| < 1024),
// and the group's sums go to the registers of the lane whose number is the
// slot: no atomics while the strip is scanned.  At the end of the strip
// each lane with members hands its sums on once (the kernel's flush, by
// the slot's view index).  A centre that is not among the first 32
// survivors, or that a pixel with an empty window took, is handed on at
// once by the group's leader (the kernel's spill, by the centre's id);
// both are rare.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace slic {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kFixedScale = 65536.f;  // 2^16: L, a, b fixed point
constexpr int kThreads = 256;           // both kernels' block size
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 32;              // a tile row is one warp wide
constexpr int kTileH = 32;              // a tile's rows
constexpr int kStripRows = kTileH / kWarps;  // a warp's rows, R

__device__ __forceinline__ float half_norm2(float l, float a, float b,
                                            float yr, float xr) {
  float s = __fadd_rn(__fmul_rn(l, l), __fmul_rn(a, a));
  s = __fadd_rn(s, __fmul_rn(b, b));
  s = __fadd_rn(s, __fmul_rn(yr, yr));
  s = __fadd_rn(s, __fmul_rn(xr, xr));
  return __fmul_rn(0.5f, s);
}

// A centre in shared memory is two 16-byte rows: pos = (y, x, L, a) with
// the raw coordinates of the window test, feat = (b, y*r, x*r, |c|^2/2).
__device__ __forceinline__ void set_center(float l, float a, float b,
                                           float y, float x, float ratio,
                                           float4* pos, float4* feat) {
  const float yr = __fmul_rn(y, ratio), xr = __fmul_rn(x, ratio);
  *pos = make_float4(y, x, l, a);
  *feat = make_float4(b, yr, xr, half_norm2(l, a, b, yr, xr));
}

// Centres in shared memory: the rows set_center wrote, and their ids
// (null: the index is the id).
struct SharedCentres {
  const float4* pos;
  const float4* feat;
  const int* ids;
  int n;
  __device__ __forceinline__ float4 get_pos(int j) const { return pos[j]; }
  __device__ __forceinline__ float4 get_feat(int j) const { return feat[j]; }
  __device__ __forceinline__ int id(int j) const {
    return ids != nullptr ? ids[j] : j;
  }
};

// An image's (K, 5) centre rows in device memory, the float4 pair of a
// row computed on use exactly as set_center computes it.
struct GlobalCentres {
  const float* rows;
  int n;
  float ratio;
  __device__ __forceinline__ float4 get_pos(int j) const {
    const float* c = rows + (size_t)j * 5;
    return make_float4(c[3], c[4], c[0], c[1]);
  }
  __device__ __forceinline__ float4 get_feat(int j) const {
    const float* c = rows + (size_t)j * 5;
    const float yr = __fmul_rn(c[3], ratio), xr = __fmul_rn(c[4], ratio);
    return make_float4(c[2], yr, xr, half_norm2(c[0], c[1], c[2], yr, xr));
  }
  __device__ __forceinline__ int id(int j) const { return j; }
};

// f32 score p.c - |c|^2/2 in a fixed order, each operation rounded
__device__ __forceinline__ float score(float4 pos, float4 feat, float l,
                                       float a, float b, float yr,
                                       float xr) {
  float s = __fadd_rn(__fmul_rn(pos.z, l), __fmul_rn(pos.w, a));
  s = __fadd_rn(s, __fmul_rn(feat.x, b));
  s = __fadd_rn(s, __fmul_rn(feat.y, yr));
  s = __fadd_rn(s, __fmul_rn(feat.z, xr));
  return __fsub_rn(s, feat.w);
}

// One strip's sums of the six fields: fixed-point L, a, b, then y, x and
// the count.  A strip's y and x sums fit 32 bits while 32 R max(H, W) <
// 2^32, which the kernels' side limit keeps.
struct Sums {
  long long l, a, b;
  unsigned y, x, n;
};

// The strip of R rows from y0 and 32 columns from x0 (cut at the image's
// edge): loads the lane's R pixels, finds each one's centre among the
// candidates of ``cand`` (see the file comment; ``all`` holds every centre
// for the empty-window fallback), writes the labels when out is not null
// (out indexes pixels py * width + px), and with kSums sums the members:
// spill(id, sums) hands on a group whose centre has no register slot,
// flush(j, sums) a lane's slot sums at the end, j the slot's index in
// ``cand``.  Every lane of the warp calls it.
template <bool kSums, typename Cand, typename All, typename Spill,
          typename Flush>
__device__ __forceinline__ void scan_strip_over(
    const Cand& cand, const All& all, const float* __restrict__ p_l, int hw,
    int height, int width, int y0, int x0, float ratio, float window,
    int32_t* __restrict__ out, Spill spill, Flush flush) {
  constexpr int R = kStripRows;
  const int lane = threadIdx.x & 31;
  const int px = x0 + lane;
  const float fx = (float)px;
  const float xr = __fmul_rn(fx, ratio);
  float l[R], a[R], b[R], fy[R], yr[R], best_s[R];
  int best[R], slot[R];
  bool valid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    valid[r] = y0 + r < height && px < width;
    const int p = valid[r] ? (y0 + r) * width + px : 0;
    l[r] = valid[r] ? p_l[p] : 0.f;
    a[r] = valid[r] ? p_l[hw + p] : 0.f;
    b[r] = valid[r] ? p_l[2 * hw + p] : 0.f;
    fy[r] = (float)(y0 + r);
    yr[r] = __fmul_rn(fy[r], ratio);
    best_s[r] = -INFINITY;
    best[r] = -1;
    slot[r] = -1;
  }

  // the candidates, 32 centres at a time, in increasing id order
  const float pad = __fadd_rn(window, 1.f);
  const float lo_y = __fsub_rn((float)y0, pad);
  const float hi_y = __fadd_rn((float)(min(y0 + R, height) - 1), pad);
  const float lo_x = __fsub_rn((float)x0, pad);
  const float hi_x = __fadd_rn((float)(min(x0 + 32, width) - 1), pad);
  int n_cand = 0, my_slot = -1;  // slot n_cand's index in cand, on lane n_cand
  for (int base = 0; base < cand.n; base += 32) {
    bool keep = false;
    if (base + lane < cand.n) {
      const float4 c = cand.get_pos(base + lane);
      keep = c.x >= lo_y && c.x <= hi_y && c.y >= lo_x && c.y <= hi_x;
    }
    for (unsigned vote = __ballot_sync(kFullMask, keep); vote;
         vote &= vote - 1, ++n_cand) {
      const int j = base + __ffs(vote) - 1;
      if (lane == n_cand) my_slot = j;
      const float4 c = cand.get_pos(j);
      if (fabsf(fx - c.y) > window) continue;
      const float4 f = cand.get_feat(j);
      const int k = cand.id(j);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (fabsf(fy[r] - c.x) <= window) {
          const float s = score(c, f, l[r], a[r], b[r], yr[r], xr);
          if (s > best_s[r]) {
            best_s[r] = s;
            best[r] = k;
            slot[r] = n_cand;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (best[r] >= 0 || !valid[r]) continue;
    for (int k = 0; k < all.n; ++k) {  // empty window: unmasked argmax
      const float s = score(all.get_pos(k), all.get_feat(k), l[r], a[r],
                            b[r], yr[r], xr);
      if (s > best_s[r]) { best_s[r] = s; best[r] = all.id(k); }
    }
  }
  if (out != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (valid[r]) out[(y0 + r) * width + px] = best[r];
  }
  if (!kSums) return;

  Sums mine = {0, 0, 0, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    // group key: the slot, or 32 + id for a centre without a register slot
    const int key = !valid[r] ? -1 : slot[r] >= 0 && slot[r] < 32
                                         ? slot[r] : 32 + best[r];
    const int q_l = __float2int_rn(l[r] * kFixedScale);
    const int q_a = __float2int_rn(a[r] * kFixedScale);
    const int q_b = __float2int_rn(b[r] * kFixedScale);
    unsigned pending = __ballot_sync(kFullMask, key >= 0);
    while (pending) {
      const int leader = __ffs(pending) - 1;
      const int k = __shfl_sync(kFullMask, key, leader);
      const bool in = key == k;
      const unsigned group = __ballot_sync(kFullMask, in);
      const unsigned n = __popc(group);
      const Sums g = {__reduce_add_sync(kFullMask, in ? q_l : 0),
                      __reduce_add_sync(kFullMask, in ? q_a : 0),
                      __reduce_add_sync(kFullMask, in ? q_b : 0),
                      n * (unsigned)(y0 + r),
                      __reduce_add_sync(kFullMask, in ? (unsigned)px : 0u),
                      n};
      if (k < 32) {
        if (lane == k) {
          mine.l += g.l; mine.a += g.a; mine.b += g.b;
          mine.y += g.y; mine.x += g.x; mine.n += g.n;
        }
      } else if (lane == leader) {
        spill(k - 32, g);
      }
      pending &= ~group;
    }
  }
  if (mine.n > 0u) flush(my_slot, mine);
}

// The scan over an image's K centres staged whole in shared memory, ids
// 0..K-1 (the Lloyd kernel's form).
template <bool kSums, typename Spill, typename Flush>
__device__ __forceinline__ void scan_strip(
    const float4* pos, const float4* feat, int n_centers,
    const float* __restrict__ p_l, int hw, int height, int width, int y0,
    int x0, float ratio, float window, int32_t* __restrict__ out,
    Spill spill, Flush flush) {
  const SharedCentres centres = {pos, feat, nullptr, n_centers};
  scan_strip_over<kSums>(centres, centres, p_l, hw, height, width, y0, x0,
                         ratio, window, out, spill, flush);
}

// A signed 64-bit sum in shared memory as two 32-bit words, added with
// native 32-bit atomics (a 64-bit shared atomic add is a compare-and-swap
// loop): each add carries out of the low word into the high word exactly
// when it wraps the low word, so the pair holds the exact sum mod 2^64
// whatever the order of the adds.
__device__ __forceinline__ void add_split(unsigned* lo, unsigned* hi,
                                          long long v) {
  const unsigned v_lo = (unsigned)v;
  const unsigned v_hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(lo, v_lo);
  atomicAdd(hi, v_hi + (old + v_lo < old ? 1u : 0u));
}

__device__ __forceinline__ long long join_split(unsigned lo, unsigned hi) {
  return (long long)(((unsigned long long)hi << 32) | lo);
}

}  // namespace slic
