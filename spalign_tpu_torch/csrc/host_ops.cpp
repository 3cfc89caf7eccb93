// Felzenszwalb-Huttenlocher graph-based image segmentation, plus a
// connectivity/min-size post-pass shared with the device SLIC path.
//
// The port's host library: a copy of spalign_tpu/native/felzenszwalb.cpp
// (the port imports nothing of the JAX package), built by g++ at first
// use (kernels/_build.py HostLibrary).  The reference relied
// on scikit-image's Cython implementation (reference
// batch_spalign_kmeans.py:28,299-313); this is a fresh C++ implementation
// of the published algorithm (Felzenszwalb & Huttenlocher, IJCV 2004)
// with skimage-compatible conventions:
//   * per-channel Gaussian pre-smoothing (sigma, truncate=4, reflect)
//   * 8-connected grid graph, edge weight = Euclidean color distance
//   * threshold function tau(C) = scale / |C|
//   * post-merge of components smaller than min_size
//   * contiguous labels ordered by first raster occurrence
//
// Exposed via ctypes (see spalign_tpu_torch/native.py); no Python
// objects cross the boundary.  The same source and the same g++ flags as
// the JAX package's library give the same label maps.  Relabel's three
// entry points compile here but are not bound yet.
//
// The image I/O of the port follows them: the yuv420 wire pack, PNG
// row un-filtering and cv2's cubic resize of uint8 images.  Each works
// on a slice of a batch; native.py splits a batch over threads (ctypes
// releases the GIL).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

// Border marker for edge-weight planes: sorts after every real color
// distance (weights are finite and tiny by comparison).
inline float FLT_MAX_SENTINEL() { return std::numeric_limits<float>::max(); }

struct DisjointSet {
  std::vector<int32_t> parent;
  std::vector<int32_t> size;

  explicit DisjointSet(int32_t n) : parent(n), size(n, 1) {
    std::iota(parent.begin(), parent.end(), 0);
  }

  int32_t find(int32_t x) {
    // path halving: one pass, same roots as full compression (the
    // internal tree shape never affects which root represents a set)
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }

  // Union by SIZE (two arrays instead of rank's three — the random-
  // access working set is the hot loops' cost; same near-constant
  // amortized find, and the same policy as the numpy oracle's
  // _UnionFind).  Tree shape never affects the output: components are
  // sets, and labels are assigned by first raster occurrence.
  int32_t merge(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return a;
    if (size[a] < size[b]) std::swap(a, b);
    parent[b] = a;
    size[a] += size[b];
    return a;
  }
};

// Separable Gaussian blur, reflect boundary, truncate = 4 sigma.
//
// Tap loops are INTERCHANGED (x contiguous in the inner loop, one tap
// pair per outer iteration): the natural per-pixel tap loop has a
// runtime trip count the compiler refuses to vectorize; this shape
// vectorizes.  `tmp` is caller-provided scratch of h*w floats so the
// per-channel calls don't churn the allocator.
void gaussian_blur(const float* src, float* dst, float* tmp, int h, int w,
                   float sigma) {
  if (sigma <= 0.f) {
    std::memcpy(dst, src, sizeof(float) * h * w);
    return;
  }
  int radius = std::max(1, (int)std::ceil(4.0f * sigma));
  std::vector<float> k(radius + 1);
  float s2 = 2.f * sigma * sigma;
  float norm = 0.f;
  for (int i = 0; i <= radius; ++i) {
    k[i] = std::exp(-(float)(i * i) / s2);
    norm += (i == 0) ? k[i] : 2.f * k[i];
  }
  for (int i = 0; i <= radius; ++i) k[i] /= norm;

  auto reflect = [](int i, int n) {
    // scipy 'reflect' (a b c | c b a)
    if (n == 1) return 0;
    int period = 2 * n;
    i = ((i % period) + period) % period;
    return (i < n) ? i : (period - 1 - i);
  };

  // horizontal: reflect only near the borders; the interior accumulates
  // one (left, right) tap pair per pass over a contiguous x range
  for (int y = 0; y < h; ++y) {
    const float* row = src + (size_t)y * w;
    float* out = tmp + (size_t)y * w;
    int lo = std::min(radius, w);
    int hi = std::max(lo, w - radius);
    for (int x = 0; x < lo; ++x) {
      float acc = k[0] * row[x];
      for (int r = 1; r <= radius; ++r)
        acc += k[r] * (row[reflect(x - r, w)] + row[reflect(x + r, w)]);
      out[x] = acc;
    }
    for (int x = lo; x < hi; ++x) out[x] = k[0] * row[x];
    for (int r = 1; r <= radius; ++r) {
      const float kr = k[r];
      const float* l = row - r;
      const float* rt = row + r;
      for (int x = lo; x < hi; ++x) out[x] += kr * (l[x] + rt[x]);
    }
    for (int x = hi; x < w; ++x) {
      float acc = k[0] * row[x];
      for (int r = 1; r <= radius; ++r)
        acc += k[r] * (row[reflect(x - r, w)] + row[reflect(x + r, w)]);
      out[x] = acc;
    }
  }
  // vertical: the reflected row indices depend only on y — one tap pair
  // of contiguous rows per inner pass
  for (int y = 0; y < h; ++y) {
    float* out = dst + (size_t)y * w;
    const float* mid = tmp + (size_t)y * w;
    const float k0 = k[0];
    for (int x = 0; x < w; ++x) out[x] = k0 * mid[x];
    for (int r = 1; r <= radius; ++r) {
      const float kr = k[r];
      const float* up = tmp + (size_t)reflect(y - r, h) * w;
      const float* dn = tmp + (size_t)reflect(y + r, h) * w;
      for (int x = 0; x < w; ++x) out[x] += kr * (up[x] + dn[x]);
    }
  }
}

// Stable ascending order of non-negative float weights over packed
// (key << 32 | seq) words.  The bit pattern of a non-negative IEEE
// float is order-isomorphic to its value, and counting passes are
// stable, so the result is EXACTLY the permutation std::stable_sort
// would produce.
//
// Method: LSD radix over the 32 key bits in THREE 11-bit digits
// (2048-bucket counting scatters — write pointers fit L1/L2, unlike
// the 16-bit variant's 64k streams) with ALL digit histograms arriving
// precomputed (fused into the caller's pack loop: one fewer full sweep
// of the edge array).  A pass whose digit is constant across the whole
// array reorders nothing and is SKIPPED outright — real edge weights
// cluster (flat image regions give runs of tiny/zero weights, and the
// exponent bits move slowly), so the top digits are frequently
// degenerate.
constexpr int kRadixBits = 11;
constexpr int kRadixBuckets = 1 << kRadixBits;  // 2048
constexpr int kRadixPasses = 3;                 // 3 * 11 >= 32 key bits

void sort_keyed_stable(std::vector<uint64_t>& a,
                       std::vector<uint32_t>& hists) {
  const size_t m = a.size();
  std::vector<uint64_t> b(m);
  uint64_t* src = a.data();
  uint64_t* dst = b.data();
  for (int pass = 0; pass < kRadixPasses; ++pass) {
    uint32_t* count = hists.data() + (size_t)pass * kRadixBuckets;
    const int shift = 32 + kRadixBits * pass;
    bool constant = false;
    for (int d = 0; d < kRadixBuckets; ++d) {
      if (count[d] == m) {
        constant = true;
        break;
      }
      if (count[d] != 0) break;  // >=2 nonzero buckets: must scatter
    }
    if (constant) continue;  // digit identical everywhere: no reorder
    uint32_t sum = 0;
    for (int d = 0; d < kRadixBuckets; ++d) {
      uint32_t c = count[d];
      count[d] = sum;
      sum += c;
    }
    for (size_t i = 0; i < m; ++i)
      dst[count[(src[i] >> shift) & (kRadixBuckets - 1)]++] = src[i];
    std::swap(src, dst);
  }
  if (src != a.data()) a.swap(b);
}

// Relabel root ids to contiguous 0..S-1 by first raster occurrence.
int32_t relabel(DisjointSet& ds, int32_t n, int32_t* labels_out) {
  std::vector<int32_t> remap(n, -1);
  int32_t next = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t r = ds.find(i);
    if (remap[r] < 0) remap[r] = next++;
    labels_out[i] = remap[r];
  }
  return next;
}

// Same, over a bare parent array (the felzenszwalb main path keeps its
// union-find as separate parent / {size,threshold} arrays — see below).
int32_t relabel_parents(std::vector<int32_t>& parent, int32_t n,
                        int32_t* labels_out) {
  std::vector<int32_t> remap(n, -1);
  int32_t next = 0;
  for (int32_t i = 0; i < n; ++i) {
    int32_t x = i;
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    if (remap[x] < 0) remap[x] = next++;
    labels_out[i] = remap[x];
  }
  return next;
}

// IEEE binary16 <-> binary32 (round-to-nearest-even), portable — no
// F16C dependency.  Used by the f16 LUT ops below.
inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t man = h & 0x3FFu;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: renormalize
      int shift = 0;
      while (!(man & 0x400u)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3FFu;
      bits = sign | ((uint32_t)(127 - 15 - shift) << 23) | (man << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);  // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
}

inline uint16_t float_to_half(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  uint32_t fexp = (x >> 23) & 0xFFu;
  uint32_t man = x & 0x7FFFFFu;
  if (fexp == 0xFFu)  // inf / nan
    return (uint16_t)(sign | 0x7C00u | (man ? 0x200u : 0));
  int32_t exp = (int32_t)fexp - 127 + 15;
  if (exp >= 31) return (uint16_t)(sign | 0x7C00u);  // overflow -> inf
  if (exp <= 0) {                                    // subnormal / zero
    if (exp < -10) return (uint16_t)sign;
    man |= 0x800000u;
    int shift = 14 - exp;
    uint32_t hman = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1u);
    uint32_t half = 1u << (shift - 1);
    if (rem > half || (rem == half && (hman & 1u))) ++hman;
    return (uint16_t)(sign | hman);
  }
  uint16_t h = (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
  uint32_t rem = man & 0x1FFFu;
  // RNE; a mantissa carry propagates into the exponent correctly
  if (rem > 0x1000u || (rem == 0x1000u && (h & 1u))) ++h;
  return h;
}

// Stage timing for optimization work only: SPALIGN_FELZ_TIMING=1 prints
// per-stage microseconds to stderr.  Off (the default) it is one cached
// getenv test per call.
struct StageClock {
  bool on;
  std::chrono::steady_clock::time_point t;
  explicit StageClock() {
    static const bool enabled = [] {
      const char* e = std::getenv("SPALIGN_FELZ_TIMING");
      return e && e[0] == '1';
    }();
    on = enabled;
    if (on) t = std::chrono::steady_clock::now();
  }
  void lap(const char* name) {
    if (!on) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[felz] %-10s %7.0f us\n", name,
                 std::chrono::duration<double, std::micro>(now - t).count());
    t = now;
  }
};

}  // namespace

extern "C" {

// img: (h, w, c) float32 row-major, any value scale (caller normalizes).
// labels_out: (h, w) int32.  Returns the number of segments, or -1 on
// invalid arguments.
int32_t spalign_felzenszwalb(const float* img, int32_t h, int32_t w,
                             int32_t c, float scale, float sigma,
                             int32_t min_size, int32_t* labels_out) {
  if (h <= 0 || w <= 0 || c <= 0 || !img || !labels_out) return -1;
  const int64_t n = (int64_t)h * w;
  StageClock clk;

  // Smooth each channel into planar layout.  De-interleave ALL channels
  // in one pass over the interleaved image (one read stream instead of
  // c strided sweeps), then blur each plane with shared scratch.
  std::vector<float> smooth((size_t)c * n);
  {
    std::vector<float> planes((size_t)c * n);
    if (c == 3) {
      float* p0 = planes.data();
      float* p1 = planes.data() + n;
      float* p2 = planes.data() + 2 * (size_t)n;
      for (int64_t i = 0; i < n; ++i) {
        p0[i] = img[i * 3 + 0];
        p1[i] = img[i * 3 + 1];
        p2[i] = img[i * 3 + 2];
      }
    } else {
      for (int ch = 0; ch < c; ++ch) {
        float* p = planes.data() + (size_t)ch * n;
        for (int64_t i = 0; i < n; ++i) p[i] = img[i * c + ch];
      }
    }
    std::vector<float> tmp(n);
    for (int ch = 0; ch < c; ++ch)
      gaussian_blur(planes.data() + (size_t)ch * n,
                    smooth.data() + (size_t)ch * n, tmp.data(), h, w, sigma);
  }
  clk.lap("blur");

  // 8-connected edge weights, one CONTIGUOUS plane per direction
  // (E=+1, S=+w, SE=+w+1, SW=+w-1): the shifted-difference loops below
  // are branch-free over the pixel index, so the compiler vectorizes
  // them.  Border positions where a direction leaves the image get
  // a FLT_MAX sentinel: it sorts after every real weight (weights are
  // finite color distances) and the union-find sweeps stop there.
  static const int kOffE = 0, kOffS = 1, kOffSE = 2, kOffSW = 3;
  const int32_t offs[4] = {1, w, w + 1, w - 1};
  std::vector<float> wdir((size_t)4 * n, FLT_MAX_SENTINEL());
  for (int d = 0; d < 4; ++d) {
    float* wd = wdir.data() + (size_t)d * n;
    const int64_t off = offs[d];
    const int64_t lim = n - off;
    if (lim <= 0) continue;
    std::fill(wd, wd + lim, 0.f);
    for (int ch = 0; ch < c; ++ch) {
      const float* s = smooth.data() + (size_t)ch * n;
      for (int64_t i = 0; i < lim; ++i) {
        float dd = s[i] - s[i + off];
        wd[i] += dd * dd;
      }
    }
    for (int64_t i = 0; i < lim; ++i) wd[i] = std::sqrt(wd[i]);
    // mask the wrap-around columns: E/SE invalid at x = w-1, SW at x = 0
    if (d == kOffE || d == kOffSE) {
      for (int64_t i = w - 1; i < lim; i += w) wd[i] = FLT_MAX_SENTINEL();
    } else if (d == kOffSW) {
      for (int64_t i = 0; i < lim; i += w) wd[i] = FLT_MAX_SENTINEL();
    }
    (void)kOffS;
  }
  clk.lap("planes");

  // Pack (weight bits << 32 | p*4 + d): ties sort by (pixel, direction)
  // with directions in E,S,SE,SW order — the exact stable order of the
  // raster-scan edge list this encoding replaces (and of
  // _felzenszwalb_np's per-pixel convention).  All three radix digit
  // histograms are built HERE, in the same pass that reads the weights
  // (the counters are 24 KB — L1-resident, unlike a separate histogram
  // sweep over the multi-MB edge array).
  std::vector<uint64_t> keyed((size_t)4 * n);
  std::vector<uint32_t> hists((size_t)kRadixPasses * kRadixBuckets, 0);
  {
    const float* w0 = wdir.data();
    const float* w1 = wdir.data() + (size_t)n;
    const float* w2 = wdir.data() + (size_t)2 * n;
    const float* w3 = wdir.data() + (size_t)3 * n;
    uint32_t* h0 = hists.data();
    uint32_t* h1 = hists.data() + kRadixBuckets;
    uint32_t* h2 = hists.data() + 2 * kRadixBuckets;
    constexpr uint32_t kMask = kRadixBuckets - 1;
    for (int64_t p = 0; p < n; ++p) {
      uint32_t k[4];
      std::memcpy(&k[0], w0 + p, 4);
      std::memcpy(&k[1], w1 + p, 4);
      std::memcpy(&k[2], w2 + p, 4);
      std::memcpy(&k[3], w3 + p, 4);
      const uint64_t base = (uint64_t)(uint32_t)(p << 2);
      for (int d = 0; d < 4; ++d) {
        keyed[(size_t)4 * p + d] = ((uint64_t)k[d] << 32) | (base + d);
        h0[k[d] & kMask]++;
        h1[(k[d] >> kRadixBits) & kMask]++;
        h2[k[d] >> (2 * kRadixBits)]++;
      }
    }
  }
  clk.lap("pack+hist");
  sort_keyed_stable(keyed, hists);
  clk.lap("sort");
  uint32_t sentinel_bits;
  {
    float s = FLT_MAX_SENTINEL();
    std::memcpy(&sentinel_bits, &s, 4);
  }

  // Union-find as a bare parent array plus packed {size, threshold}
  // nodes: the sweep reads BOTH fields for both roots on every edge, so
  // packing them puts each root's pair on one cache line (two random
  // loads per edge instead of four into separate 200 KB arrays).
  std::vector<int32_t> parent(n);
  std::iota(parent.begin(), parent.end(), 0);
  struct Node {
    int32_t size;
    float threshold;  // tau(C) = scale / |C|, |C|=1 initially
  };
  std::vector<Node> node(n, Node{1, scale});
  auto find = [&parent](int32_t x) {
    // path halving: one pass, same roots as full compression (the
    // internal tree shape never affects which root represents a set)
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };

  constexpr size_t kPF = 12;  // edges of lookahead for the prefetches
  const size_t m_all = keyed.size();
  // number of components below min_size, maintained across both sweeps:
  // the post-pass can stop the moment it hits zero (real images absorb
  // most fragments early in the ascending-weight order)
  int64_t n_small = (min_size > 1) ? n : 0;
  // Edges that FAIL the threshold test are the only ones that can still
  // join two roots in the min-size post-pass (merged edges end up
  // same-root; same-root edges stay same-root), so record them — in
  // sweep order, i.e. ascending weight — and post-scan only that list.
  std::vector<uint32_t> boundary;
  boundary.reserve((size_t)n / 4);
  for (size_t s = 0; s < m_all; ++s) {
    const uint64_t word = keyed[s];
    const uint32_t kbits = (uint32_t)(word >> 32);
    if (kbits == sentinel_bits) break;  // all real edges processed
    if (s + kPF < m_all) {
      // the union-find roots chase pointers through 200 KB+ arrays in
      // edge order, which is effectively random: prefetch the two
      // endpoint parents a few edges ahead (the chains are short after
      // path halving, so the first hop covers most of the latency)
      const uint32_t fi = (uint32_t)keyed[s + kPF];
      const int32_t fp = (int32_t)(fi >> 2);
      __builtin_prefetch(&parent[fp]);
      __builtin_prefetch(&parent[fp + offs[fi & 3]]);
    }
    const uint32_t i = (uint32_t)word;
    const int32_t p = (int32_t)(i >> 2);
    float ew;
    std::memcpy(&ew, &kbits, 4);
    int32_t a = find(p);
    int32_t b = find(p + offs[i & 3]);
    if (a == b) continue;
    // branchless pair test: one compare against min(tau_a, tau_b)
    // (identical result to `ew <= ta && ew <= tb`; always loading both
    // thresholds costs less than the mispredicts of the && form)
    const Node na = node[a], nb = node[b];
    if (ew <= std::min(na.threshold, nb.threshold)) {
      n_small -= (na.size < min_size) + (nb.size < min_size);
      // union by size (same policy as DisjointSet::merge / the numpy
      // oracle; tree shape never affects which pixels share a root)
      int32_t root = a, child = b;
      if (na.size < nb.size) std::swap(root, child);
      parent[child] = root;
      const int32_t ns = na.size + nb.size;
      node[root] = Node{ns, ew + scale / (float)ns};
      n_small += ns < min_size;
    } else {
      boundary.push_back(i);
    }
  }
  clk.lap("sweep");

  // Post-pass: absorb small components (same ascending edge order over
  // the recorded boundary edges), stopping as soon as none remain.
  if (min_size > 1 && n_small > 0) {
    for (uint32_t i : boundary) {
      const int32_t p = (int32_t)(i >> 2);
      int32_t a = find(p);
      int32_t b = find(p + offs[i & 3]);
      if (a != b &&
          (node[a].size < min_size || node[b].size < min_size)) {
        n_small -= (node[a].size < min_size) + (node[b].size < min_size);
        int32_t root = a, child = b;
        if (node[a].size < node[b].size) std::swap(root, child);
        parent[child] = root;
        node[root].size += node[child].size;
        n_small += node[root].size < min_size;
        if (n_small == 0) break;
      }
    }
  }
  clk.lap("minsize");

  int32_t n_seg = relabel_parents(parent, (int32_t)n, labels_out);
  clk.lap("relabel");
  return n_seg;
}

// Enforce 4-connectivity of an arbitrary label map (e.g. device SLIC
// output) and absorb connected components smaller than min_size into an
// adjacent component.  labels_in/labels_out: (h, w) int32.  Returns the
// number of segments.
int32_t spalign_enforce_connectivity(const int32_t* labels_in, int32_t h,
                                     int32_t w, int32_t min_size,
                                     int32_t* labels_out) {
  if (h <= 0 || w <= 0 || !labels_in || !labels_out) return -1;
  const int64_t n = (int64_t)h * w;
  DisjointSet ds((int32_t)n);
  // union same-label 4-neighbors
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      int64_t p = (int64_t)y * w + x;
      if (x + 1 < w && labels_in[p] == labels_in[p + 1])
        ds.merge((int32_t)p, (int32_t)(p + 1));
      if (y + 1 < h && labels_in[p] == labels_in[p + w])
        ds.merge((int32_t)p, (int32_t)(p + w));
    }
  }
  // absorb small components into any 4-neighbor component (preferring the
  // earlier-merged larger one by scanning until stable)
  if (min_size > 1) {
    bool changed = true;
    while (changed) {
      changed = false;
      for (int y = 0; y < h; ++y) {
        for (int x = 0; x < w; ++x) {
          int32_t p = (int32_t)((int64_t)y * w + x);
          int32_t rp = ds.find(p);
          if (ds.size[rp] >= min_size) continue;
          int32_t best = -1, best_size = -1;
          auto consider = [&](int32_t q) {
            int32_t rq = ds.find(q);
            if (rq != rp && ds.size[rq] > best_size) {
              best = rq;
              best_size = ds.size[rq];
            }
          };
          if (x + 1 < w) consider(p + 1);
          if (x > 0) consider(p - 1);
          if (y + 1 < h) consider(p + w);
          if (y > 0) consider(p - w);
          if (best >= 0) {
            ds.merge(rp, best);
            changed = true;
          }
        }
      }
    }
  }
  return relabel(ds, (int32_t)n, labels_out);
}


// Fused full-resolution confusion scorer: NN-upsample the small
// (ph, pw) road mask to (H, W) (the float32 index convention of
// ops/resize.nn_resize_cv2: src = floor(dst * (src_len/dst_len)),
// exact for the power-of-two eval shapes) and accumulate the 2x2
// confusion against RAW Cityscapes labelIds (void 0..6 ignored, road
// 7 -> gt 1, else gt 0) in ONE pass.  Replaces a 4-pass numpy chain
// (resize + LUT gather + index arithmetic + bincount) on the host
// loop's scoring stage.  out: [tn, fp, fn, tp] i.e.
// conf[gt][pred] row-major.  Returns 0, or -1 on invalid arguments.
int32_t spalign_confusion(const uint8_t* pred, int32_t ph, int32_t pw,
                          const uint8_t* gt, int32_t H, int32_t W,
                          int64_t* out) {
  if (!pred || !gt || !out || ph <= 0 || pw <= 0 || H <= 0 || W <= 0)
    return -1;
  std::vector<int32_t> xmap((size_t)W);
  const float sx_scale = (float)pw / (float)W;
  for (int32_t x = 0; x < W; ++x) {
    int32_t sx = (int32_t)std::floor((float)x * sx_scale);
    xmap[(size_t)x] = sx < 0 ? 0 : (sx >= pw ? pw - 1 : sx);
  }
  uint8_t lut[256];
  for (int32_t i = 0; i < 256; ++i)
    lut[i] = (uint8_t)(i < 7 ? 0 : (i == 7 ? 2 : 1));
  int64_t cnt[6] = {0, 0, 0, 0, 0, 0};
  const float sy_scale = (float)ph / (float)H;
  for (int32_t y = 0; y < H; ++y) {
    int32_t sy = (int32_t)std::floor((float)y * sy_scale);
    if (sy >= ph) sy = ph - 1;
    if (sy < 0) sy = 0;
    const uint8_t* pr = pred + (size_t)sy * (size_t)pw;
    const uint8_t* gr = gt + (size_t)y * (size_t)W;
    for (int32_t x = 0; x < W; ++x)
      cnt[lut[gr[x]] * 2 + (pr[xmap[(size_t)x]] ? 1 : 0)]++;
  }
  out[0] = cnt[2];
  out[1] = cnt[3];
  out[2] = cnt[4];
  out[3] = cnt[5];
  return 0;
}

// out[i] = (binary16) 1.0f - in[i] over raw f16 bit patterns, via a
// 65536-entry LUT (one conversion table covers every possible input).
// The relabel pass derives softmax channel 1 as 1 - ch0 on megapixel
// f16 planes (labels_from_segnet.py:91-95 stores both channels); a
// table gather in place of numpy's scalarized f16 cast.
int32_t spalign_one_minus_f16(const uint16_t* in, uint16_t* out,
                              int64_t n) {
  if (!in || !out || n < 0) return -1;
  static const uint16_t* lut = [] {
    uint16_t* t = new uint16_t[65536];
    for (uint32_t v = 0; v < 65536; ++v)
      t[v] = float_to_half(1.0f - half_to_float((uint16_t)v));
    return t;
  }();
  for (int64_t i = 0; i < n; ++i) out[i] = lut[in[i]];
  return 0;
}

// 2x2 confusion of a full-res {0,1} pred against gt labels in
// {-1, 0, 1} (anything outside {0, 1} is void and ignored — the
// relabel eval convention, selftrain/relabel.py), in one pass in place
// of the numpy add+bincount chain.
// out: int64[4] = conf[gt][pred] row-major.
int32_t spalign_confusion_remapped(const uint8_t* pred, const int32_t* gt,
                                   int64_t n, int64_t* out) {
  if (!pred || !gt || !out || n < 0) return -1;
  int64_t c[4] = {0, 0, 0, 0};
  for (int64_t i = 0; i < n; ++i) {
    uint32_t g = (uint32_t)gt[i];  // negatives wrap to huge values
    if (g > 1u) continue;
    c[g * 2 + (pred[i] ? 1u : 0u)]++;
  }
  out[0] = c[0];
  out[1] = c[1];
  out[2] = c[2];
  out[3] = c[3];
  return 0;
}

// u8[i*3+c] = clip(rint(in[i*3+c] * std[c] + mean[c]), 0, 255) over an
// interleaved HWC float32 image — the relabel u8 wire's host-side
// standardization inversion (selftrain/relabel.py _to_u8), without the
// numpy chain's rint/clip/cast temporaries.
// nearbyintf under the default FE_TONEAREST mode is round-half-even,
// matching np.rint bit-for-bit.  Contraction is off: a fused
// multiply-add rounds p*s+m once where numpy rounds twice, and moves a
// value that lands on .5 after numpy's two roundings (1 in ~10^6 random
// floats, never a standardized uint8 pixel) to the other integer.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")
int32_t spalign_standardize_invert(const float* in, int64_t npix,
                                   const float* mean, const float* std3,
                                   uint8_t* out) {
  if (!in || !mean || !std3 || !out || npix < 0) return -1;
  const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
  const float s0 = std3[0], s1 = std3[1], s2 = std3[2];
  for (int64_t i = 0; i < npix; ++i) {
    const float* p = in + i * 3;
    float v0 = nearbyintf(p[0] * s0 + m0);
    float v1 = nearbyintf(p[1] * s1 + m1);
    float v2 = nearbyintf(p[2] * s2 + m2);
    out[i * 3 + 0] = (uint8_t)(v0 < 0.f ? 0.f : (v0 > 255.f ? 255.f : v0));
    out[i * 3 + 1] = (uint8_t)(v1 < 0.f ? 0.f : (v1 > 255.f ? 255.f : v1));
    out[i * 3 + 2] = (uint8_t)(v2 < 0.f ? 0.f : (v2 > 255.f ? 255.f : v2));
  }
  return 0;
}
#pragma GCC pop_options

// ---------------------------------------------------------------------
// Image I/O of the label and training paths.
// ---------------------------------------------------------------------

// yuv420 wire pack of n (h, w, 3) uint8 RGB images (pipeline/wire.py's
// pack_yuv420, bit for bit): cv2's fixed-point RGB -> YCrCb (14
// fractional bits, chroma clipped to [0, 255]), then each chroma plane
// downscaled 2x by the rounded mean of its 2x2 blocks (INTER_AREA).
// out: n rows of [Y (h*w) | Cr (h/2*w/2) | Cb (h/2*w/2)].  Returns 0,
// or -1 on invalid arguments (h or w odd).
int32_t spalign_pack_yuv420(const uint8_t* rgb, int32_t n, int32_t h,
                            int32_t w, uint8_t* out) {
  if (!rgb || !out || n < 0 || h <= 0 || w <= 0 || (h & 1) || (w & 1))
    return -1;
  const int32_t kShift = 14, kHalf = 1 << (kShift - 1);
  const int32_t kBias = (128 << kShift) + kHalf;
  const size_t hw = (size_t)h * (size_t)w, q = hw / 4;
  for (int32_t b = 0; b < n; ++b) {
    const uint8_t* img = rgb + (size_t)b * hw * 3;
    uint8_t* yp = out + (size_t)b * (hw + 2 * q);
    uint8_t* crp = yp + hw;
    uint8_t* cbp = crp + q;
    for (int32_t by = 0; by < h / 2; ++by) {
      for (int32_t bx = 0; bx < w / 2; ++bx) {
        int32_t cr_sum = 0, cb_sum = 0;
        for (int32_t dy = 0; dy < 2; ++dy) {
          for (int32_t dx = 0; dx < 2; ++dx) {
            const size_t i = (size_t)(2 * by + dy) * (size_t)w + 2 * bx + dx;
            const int32_t r = img[3 * i], g = img[3 * i + 1],
                          bl = img[3 * i + 2];
            const int32_t y = (4899 * r + 9617 * g + 1868 * bl + kHalf)
                              >> kShift;
            const int32_t cr = ((r - y) * 11682 + kBias) >> kShift;
            const int32_t cb = ((bl - y) * 9241 + kBias) >> kShift;
            yp[i] = (uint8_t)y;
            cr_sum += cr < 0 ? 0 : (cr > 255 ? 255 : cr);
            cb_sum += cb < 0 ? 0 : (cb > 255 ? 255 : cb);
          }
        }
        const size_t j = (size_t)by * (size_t)(w / 2) + bx;
        crp[j] = (uint8_t)((cr_sum + 2) >> 2);
        cbp[j] = (uint8_t)((cb_sum + 2) >> 2);
      }
    }
  }
  return 0;
}

// PNG row un-filtering (PNG spec section 9): h scanlines of 1 + row_bytes
// bytes (filter type, then the filtered bytes) -> h * row_bytes bytes.
// bpp: bytes per complete pixel (at least 1).  Sub, Average and Paeth
// read the byte bpp before in the same, already un-filtered row.
// Returns 0, -1 on invalid arguments, or -2 - y when row y carries an
// unknown filter type.
int32_t spalign_png_unfilter(const uint8_t* in, int32_t h, int64_t row_bytes,
                             int32_t bpp, uint8_t* out) {
  if (!in || !out || h < 0 || row_bytes <= 0 || bpp <= 0) return -1;
  const size_t rb = (size_t)row_bytes, pb = (size_t)bpp;
  for (int32_t y = 0; y < h; ++y) {
    const uint8_t* src = in + (size_t)y * (rb + 1);
    const uint8_t ft = src[0];
    ++src;
    uint8_t* cur = out + (size_t)y * rb;
    const uint8_t* prev = y > 0 ? cur - rb : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, src, rb);
        break;
      case 1:
        for (size_t x = 0; x < rb; ++x)
          cur[x] = (uint8_t)(src[x] + (x >= pb ? cur[x - pb] : 0));
        break;
      case 2:
        for (size_t x = 0; x < rb; ++x)
          cur[x] = (uint8_t)(src[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (size_t x = 0; x < rb; ++x) {
          const int32_t a = x >= pb ? cur[x - pb] : 0;
          const int32_t b = prev ? prev[x] : 0;
          cur[x] = (uint8_t)(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < rb; ++x) {
          const int32_t a = x >= pb ? cur[x - pb] : 0;
          const int32_t b = prev ? prev[x] : 0;
          const int32_t c = (prev && x >= pb) ? prev[x - pb] : 0;
          const int32_t p = a + b - c;
          const int32_t pa = std::abs(p - a), pbd = std::abs(p - b),
                        pc = std::abs(p - c);
          const int32_t pred = (pa <= pbd && pa <= pc) ? a
                               : (pbd <= pc ? b : c);
          cur[x] = (uint8_t)(src[x] + pred);
        }
        break;
      default:
        return -2 - y;
    }
  }
  return 0;
}

// cv2.resize(..., INTER_CUBIC) of uint8 images with cv2's default (IPP)
// arithmetic as closely as a separable float32 form gets: source
// positions (d + 0.5) * scale - 0.5 and the cubic weights (A = -0.75,
// the fourth 1 minus the other three) in float64, rounded to float32;
// the vertical pass, then the horizontal one, each a float32 sum of
// four products in tap order; borders replicated; rounded half to even
// and saturated.  Contraction to FMA is off for this code (-march=native
// would otherwise fuse the products and sums and move roundings).
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")
namespace {

void cubic_taps(int32_t n_out, int32_t n_in, std::vector<int32_t>& idx,
                std::vector<float>& wts) {
  const double scale = (double)n_in / (double)n_out, A = -0.75;
  idx.resize((size_t)n_out * 4);
  wts.resize((size_t)n_out * 4);
  for (int32_t d = 0; d < n_out; ++d) {
    const double f = ((double)d + 0.5) * scale - 0.5;
    const double s = std::floor(f), x = f - s;
    const double c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1)
                      - 4 * A;
    const double c1 = ((A + 2) * x - (A + 3)) * x * x + 1;
    const double c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1;
    const double c3 = 1 - c0 - c1 - c2;
    const double c[4] = {c0, c1, c2, c3};
    for (int32_t k = 0; k < 4; ++k) {
      int64_t i = (int64_t)s + k - 1;
      i = i < 0 ? 0 : (i >= n_in ? n_in - 1 : i);
      idx[(size_t)d * 4 + k] = (int32_t)i;
      wts[(size_t)d * 4 + k] = (float)c[k];
    }
  }
}

}  // namespace

// n images (H, W, C) uint8 -> (h, w, C) uint8.  Returns 0, or -1 on
// invalid arguments.
int32_t spalign_resize_cubic_u8(const uint8_t* src, int32_t n, int32_t H,
                                int32_t W, int32_t C, int32_t h, int32_t w,
                                uint8_t* dst) {
  if (!src || !dst || n < 0 || H <= 0 || W <= 0 || C <= 0 || h <= 0 ||
      w <= 0)
    return -1;
  std::vector<int32_t> iy, ix;
  std::vector<float> cy, cx;
  cubic_taps(h, H, iy, cy);
  cubic_taps(w, W, ix, cx);
  const size_t row_in = (size_t)W * C, row_out = (size_t)w * C;
  std::vector<float> tmp((size_t)h * row_in);
  for (int32_t b = 0; b < n; ++b) {
    const uint8_t* img = src + (size_t)b * H * row_in;
    uint8_t* out = dst + (size_t)b * h * row_out;
    for (int32_t y = 0; y < h; ++y) {
      const uint8_t* r0 = img + (size_t)iy[(size_t)y * 4] * row_in;
      const uint8_t* r1 = img + (size_t)iy[(size_t)y * 4 + 1] * row_in;
      const uint8_t* r2 = img + (size_t)iy[(size_t)y * 4 + 2] * row_in;
      const uint8_t* r3 = img + (size_t)iy[(size_t)y * 4 + 3] * row_in;
      const float* c = &cy[(size_t)y * 4];
      float* t = &tmp[(size_t)y * row_in];
      for (size_t x = 0; x < row_in; ++x) {
        float acc = c[0] * (float)r0[x];
        acc = acc + c[1] * (float)r1[x];
        acc = acc + c[2] * (float)r2[x];
        acc = acc + c[3] * (float)r3[x];
        t[x] = acc;
      }
    }
    for (int32_t y = 0; y < h; ++y) {
      const float* t = &tmp[(size_t)y * row_in];
      uint8_t* o = out + (size_t)y * row_out;
      for (int32_t x = 0; x < w; ++x) {
        const int32_t* i = &ix[(size_t)x * 4];
        const float* c = &cx[(size_t)x * 4];
        for (int32_t ch = 0; ch < C; ++ch) {
          float acc = c[0] * t[(size_t)i[0] * C + ch];
          acc = acc + c[1] * t[(size_t)i[1] * C + ch];
          acc = acc + c[2] * t[(size_t)i[2] * C + ch];
          acc = acc + c[3] * t[(size_t)i[3] * C + ch];
          const float v = nearbyintf(acc);
          o[(size_t)x * C + ch] =
              (uint8_t)(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
        }
      }
    }
  }
  return 0;
}
#pragma GCC pop_options

// Baseline JPEG of one RGB image, as IJG's libjpeg (and libjpeg-turbo)
// writes it with its defaults: JFIF APP0, YCbCr 4:2:0 (Y 2x2, Cb and Cr
// 1x1), the integer color conversion of jccolor.c, the h2v2 downsample of
// jcsample.c (1, 2, 1, 2 rounding bias along a row), the "islow" integer
// forward DCT of jfdctint.c, the Annex K quantization tables scaled by
// quality as jcparam.c scales them (baseline: at most 255), the Annex K
// Huffman tables, byte stuffing, and IJG's edge rules: edges replicated
// to whole blocks, and the blocks of the last MCU that lie past the
// image's blocks coded with AC 0 and the DC of the block before them in
// the MCU (jccoefct.c).  The demo-video writer's MJPG frames.
namespace {

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kBaseQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};
const uint8_t kDcBits[2][16] = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                                {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0}};
const uint8_t kAcBits[2][16] = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77}};
const uint8_t kAcVals[2][162] = {
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
     0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
     0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
     0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
     0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
     0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
     0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
     0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
     0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
     0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
     0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
     0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
     0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
     0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
     0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
     0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
     0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
     0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
     0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
     0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
     0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
     0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
     0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
     0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
     0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

struct HuffTable {
  uint16_t code[256];
  uint8_t size[256];
};

// Annex C: code lengths in order of the values, codes counted up.
void make_huff(const uint8_t* bits, const uint8_t* vals, HuffTable* t) {
  std::memset(t, 0, sizeof(*t));
  uint32_t code = 0;
  int32_t k = 0;
  for (int32_t len = 1; len <= 16; ++len) {
    for (int32_t i = 0; i < bits[len - 1]; ++i, ++k) {
      t->code[vals[k]] = (uint16_t)code++;
      t->size[vals[k]] = (uint8_t)len;
    }
    code <<= 1;
  }
}

// jfdctint.c (IJG 6b): 8x8 level-shifted samples in, coefficients scaled
// by 8 out, in place.
void fdct_islow(int32_t* d) {
  const int32_t kC = 13, kP = 2;
  auto descale = [](int32_t x, int32_t n) {
    return (x + (1 << (n - 1))) >> n;
  };
  for (int32_t pass = 0; pass < 2; ++pass) {
    const int32_t step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    const int32_t sh = pass == 0 ? kC - kP : kC + kP;
    for (int32_t line = 0; line < 8; ++line) {
      int32_t* p = d + line * stride;
      const int32_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      const int32_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      const int32_t t2 = p[2 * step] + p[5 * step],
                    t5 = p[2 * step] - p[5 * step];
      const int32_t t3 = p[3 * step] + p[4 * step],
                    t4 = p[3 * step] - p[4 * step];
      const int32_t t10 = t0 + t3, t13 = t0 - t3;
      const int32_t t11 = t1 + t2, t12 = t1 - t2;
      if (pass == 0) {
        p[0] = (t10 + t11) * (1 << kP);
        p[4 * step] = (t10 - t11) * (1 << kP);
      } else {
        p[0] = descale(t10 + t11, kP);
        p[4 * step] = descale(t10 - t11, kP);
      }
      int32_t z1 = (t12 + t13) * 4433;
      p[2 * step] = descale(z1 + t13 * 6270, sh);
      p[6 * step] = descale(z1 + t12 * -15137, sh);
      z1 = t4 + t7;
      int32_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      const int32_t z5 = (z3 + z4) * 9633;
      const int32_t u4 = t4 * 2446, u5 = t5 * 16819, u6 = t6 * 25172,
                    u7 = t7 * 12299;
      z1 *= -7373;
      z2 *= -20995;
      z3 = z3 * -16069 + z5;
      z4 = z4 * -3196 + z5;
      p[7 * step] = descale(u4 + z1 + z3, sh);
      p[5 * step] = descale(u5 + z2 + z4, sh);
      p[3 * step] = descale(u6 + z2 + z3, sh);
      p[step] = descale(u7 + z1 + z4, sh);
    }
  }
}

// One 8x8 block of a plane of row stride `stride`, level-shifted, DCT'd
// and quantized by `div` (quant << 3, jcdctmgr.c's rounding) into q.
void code_block(const uint8_t* plane, size_t stride, const int32_t* div,
                int32_t* q) {
  int32_t d[64];
  for (int32_t y = 0; y < 8; ++y)
    for (int32_t x = 0; x < 8; ++x)
      d[y * 8 + x] = (int32_t)plane[(size_t)y * stride + x] - 128;
  fdct_islow(d);
  for (int32_t i = 0; i < 64; ++i) {
    const int32_t v = d[i], a = (v < 0 ? -v : v) + (div[i] >> 1);
    const int32_t r = a / div[i];
    q[i] = v < 0 ? -r : r;
  }
}

struct BitWriter {
  uint8_t* out;
  int64_t cap, pos = 0;
  uint64_t acc = 0;
  int32_t nacc = 0;
  bool overflow = false;

  void put_byte(uint8_t b) {
    if (pos >= cap) {
      overflow = true;
      return;
    }
    out[pos++] = b;
  }
  void put_bits(uint32_t v, int32_t n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    nacc += n;
    while (nacc >= 8) {
      const uint8_t b = (uint8_t)(acc >> (nacc - 8));
      put_byte(b);
      if (b == 0xFF) put_byte(0);
      nacc -= 8;
    }
  }
  void flush() {
    if (nacc > 0) put_bits(0x7F, 8 - nacc);  // pad with 1-bits
  }
};

int32_t bit_length(int32_t a) {
  int32_t n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

void encode_block(BitWriter& bw, const int32_t* q, int32_t& last_dc,
                  const HuffTable& dc, const HuffTable& ac) {
  int32_t diff = q[0] - last_dc;
  last_dc = q[0];
  int32_t nb = bit_length(diff < 0 ? -diff : diff);
  bw.put_bits(dc.code[nb], dc.size[nb]);
  if (nb) bw.put_bits((uint32_t)(diff < 0 ? diff - 1 : diff), nb);
  int32_t run = 0;
  for (int32_t k = 1; k < 64; ++k) {
    const int32_t v = q[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put_bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    nb = bit_length(v < 0 ? -v : v);
    const int32_t sym = (run << 4) | nb;
    bw.put_bits(ac.code[sym], ac.size[sym]);
    bw.put_bits((uint32_t)(v < 0 ? v - 1 : v), nb);
    run = 0;
  }
  if (run > 0) bw.put_bits(ac.code[0], ac.size[0]);
}

}  // namespace

// The JPEG of one (h, w, 3) uint8 RGB image at IJG quality 1..100 into
// out[0, cap).  Returns its byte count, -1 on invalid arguments, or -2
// when cap is too small.
int64_t spalign_encode_jpeg(const uint8_t* rgb, int32_t h, int32_t w,
                            int32_t quality, uint8_t* out, int64_t cap) {
  if (!rgb || !out || h <= 0 || w <= 0 || h > 65535 || w > 65535 ||
      quality < 1 || quality > 100 || cap < 0)
    return -1;
  const int32_t scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  uint8_t quant[2][64];
  int32_t div[2][64];
  for (int32_t t = 0; t < 2; ++t)
    for (int32_t i = 0; i < 64; ++i) {
      int32_t v = ((int32_t)kBaseQuant[t][i] * scale + 50) / 100;
      v = v < 1 ? 1 : (v > 255 ? 255 : v);
      quant[t][i] = (uint8_t)v;
      div[t][i] = v << 3;
    }
  // color conversion (jccolor.c) and the padded planes: Y to whole MCUs,
  // Cb and Cr at full resolution over an even row count and whole MCU
  // columns, edges replicated
  const int32_t mh = (h + 15) / 16, mw = (w + 15) / 16;
  const int32_t hr = (h + 1) / 2;
  const size_t yw = (size_t)mw * 16, cw = (size_t)mw * 8;
  std::vector<uint8_t> yp((size_t)mh * 16 * yw);
  std::vector<int32_t> cfull((size_t)2 * hr * 2 * yw);  // Cb, Cr interleaved
  const int32_t kOff = (128 << 16) + 32767;
  for (int32_t y = 0; y < 2 * hr; ++y) {
    const uint8_t* row = rgb + (size_t)(y < h ? y : h - 1) * w * 3;
    for (size_t x = 0; x < yw; ++x) {
      const uint8_t* px = row + (size_t)(x < (size_t)w ? x : w - 1) * 3;
      const int32_t r = px[0], g = px[1], b = px[2];
      if (y < h)
        yp[(size_t)y * yw + x] =
            (uint8_t)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16);
      int32_t* c = &cfull[((size_t)y * yw + x) * 2];
      c[0] = (-11059 * r - 21709 * g + 32768 * b + kOff) >> 16;
      c[1] = (32768 * r - 27439 * g - 5329 * b + kOff) >> 16;
    }
  }
  for (int32_t y = h; y < mh * 16; ++y)
    std::memcpy(&yp[(size_t)y * yw], &yp[(size_t)(h - 1) * yw], yw);
  // h2v2 downsample (jcsample.c); rows past the image repeat the last
  std::vector<uint8_t> cplane[2];
  for (int32_t c = 0; c < 2; ++c) cplane[c].resize((size_t)mh * 8 * cw);
  for (int32_t y = 0; y < mh * 8; ++y) {
    const int32_t sy = y < hr ? y : hr - 1;
    const int32_t* r0 = &cfull[(size_t)(2 * sy) * yw * 2];
    const int32_t* r1 = r0 + yw * 2;
    for (size_t x = 0; x < cw; ++x) {
      const int32_t bias = (x & 1) ? 2 : 1;
      for (int32_t c = 0; c < 2; ++c)
        cplane[c][(size_t)y * cw + x] = (uint8_t)(
            (r0[4 * x + c] + r0[4 * x + 2 + c] + r1[4 * x + c] +
             r1[4 * x + 2 + c] + bias) >> 2);
    }
  }
  HuffTable dc[2], ac[2];
  for (int32_t t = 0; t < 2; ++t) {
    make_huff(kDcBits[t], (const uint8_t*)"\0\1\2\3\4\5\6\7\10\11\12\13",
              &dc[t]);
    make_huff(kAcBits[t], kAcVals[t], &ac[t]);
  }
  BitWriter bw{out, cap};
  auto marker = [&](uint8_t m, int32_t len) {
    bw.put_byte(0xFF);
    bw.put_byte(m);
    bw.put_byte((uint8_t)(len >> 8));
    bw.put_byte((uint8_t)len);
  };
  bw.put_byte(0xFF);
  bw.put_byte(0xD8);
  marker(0xE0, 16);
  for (uint8_t b : {'J', 'F', 'I', 'F', '\0', '\1', '\1', '\0', '\0', '\1',
                    '\0', '\1', '\0', '\0'})
    bw.put_byte((uint8_t)b);
  for (int32_t t = 0; t < 2; ++t) {
    marker(0xDB, 67);
    bw.put_byte((uint8_t)t);
    for (int32_t k = 0; k < 64; ++k) bw.put_byte(quant[t][kZigzag[k]]);
  }
  marker(0xC0, 17);
  for (uint8_t b : {(uint8_t)8, (uint8_t)(h >> 8), (uint8_t)h,
                    (uint8_t)(w >> 8), (uint8_t)w, (uint8_t)3, (uint8_t)1,
                    (uint8_t)0x22, (uint8_t)0, (uint8_t)2, (uint8_t)0x11,
                    (uint8_t)1, (uint8_t)3, (uint8_t)0x11, (uint8_t)1})
    bw.put_byte(b);
  for (int32_t t = 0; t < 2; ++t) {
    marker(0xC4, 2 + 1 + 16 + 12);
    bw.put_byte((uint8_t)t);
    for (int32_t i = 0; i < 16; ++i) bw.put_byte(kDcBits[t][i]);
    for (int32_t i = 0; i < 12; ++i) bw.put_byte((uint8_t)i);
    marker(0xC4, 2 + 1 + 16 + 162);
    bw.put_byte((uint8_t)(0x10 | t));
    for (int32_t i = 0; i < 16; ++i) bw.put_byte(kAcBits[t][i]);
    for (int32_t i = 0; i < 162; ++i) bw.put_byte(kAcVals[t][i]);
  }
  marker(0xDA, 12);
  for (uint8_t b : {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0})
    bw.put_byte(b);
  // the scan: MCUs of Y00 Y01 Y10 Y11 Cb Cr
  const int32_t bw_blocks = (w + 7) / 8, bh_blocks = (h + 7) / 8;
  int32_t last_dc[3] = {0, 0, 0};
  int32_t qy[4][64], qc[64];
  for (int32_t my = 0; my < mh; ++my) {
    for (int32_t mx = 0; mx < mw; ++mx) {
      for (int32_t i = 0; i < 4; ++i) {
        const int32_t by = 2 * my + i / 2, bx = 2 * mx + i % 2;
        if (by >= bh_blocks) {  // a row of dummy blocks
          std::memset(qy[i], 0, sizeof(qy[i]));
          qy[i][0] = qy[1][0];
        } else if (bx >= bw_blocks) {  // a dummy block at the right
          std::memset(qy[i], 0, sizeof(qy[i]));
          qy[i][0] = qy[i - 1][0];
        } else {
          code_block(&yp[(size_t)by * 8 * yw + (size_t)bx * 8], yw, div[0],
                     qy[i]);
        }
        encode_block(bw, qy[i], last_dc[0], dc[0], ac[0]);
      }
      for (int32_t c = 0; c < 2; ++c) {
        code_block(&cplane[c][(size_t)my * 8 * cw + (size_t)mx * 8], cw,
                   div[1], qc);
        encode_block(bw, qc, last_dc[1 + c], dc[1], ac[1]);
      }
    }
  }
  bw.flush();
  bw.put_byte(0xFF);
  bw.put_byte(0xD9);
  return bw.overflow ? -2 : bw.pos;
}

}  // extern "C"
