// Connected-components labeling + contour extraction for tpusfm_torch.
//
// The port's copy of tpusfm's csrc/ccl.cpp: its code is byte-for-byte
// tpusfm's, only this header differs. Native host-side runtime piece: the
// capability behind the reference's cv::findContours / contour-area sort
// (createPortraitMode, SfM-GMS/DisparityUtil.cpp:362-383) and StereoBM's
// speckle filter. Union-find with path compression, 8- or 4-connectivity;
// also exposes per-component areas and a boundary-pixel marker. Exposed
// via ctypes (tpusfm_torch/native.py).
//
// Build (native.py, at first use): g++ -O3 -shared -fPIC into
// build/tpusfm_torch/, keyed by the hash of this file and the flags.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct UF {
  std::vector<int32_t> parent;
  explicit UF(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t nxt = parent[x];
      parent[x] = root;
      x = nxt;
    }
    return root;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return;
    if (b < a) std::swap(a, b);
    parent[b] = a;
  }
};

}  // namespace

extern "C" {

// Label the nonzero pixels of mask (h*w, row-major). labels gets 0 for
// background and 1..n for components. Returns the number of components.
int32_t tpusfm_ccl_label(const uint8_t* mask, int32_t h, int32_t w,
                         int32_t connectivity, int32_t* labels) {
  const int64_t n = static_cast<int64_t>(h) * w;
  UF uf(n);
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = static_cast<int64_t>(y) * w + x;
      if (!mask[i]) continue;
      if (x > 0 && mask[i - 1]) uf.unite(i, i - 1);
      if (y > 0 && mask[i - w]) uf.unite(i, i - w);
      if (connectivity == 8 && y > 0) {
        if (x > 0 && mask[i - w - 1]) uf.unite(i, i - w - 1);
        if (x + 1 < w && mask[i - w + 1]) uf.unite(i, i - w + 1);
      }
    }
  }
  // compress to consecutive labels
  std::vector<int32_t> remap(n, 0);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (!mask[i]) {
      labels[i] = 0;
      continue;
    }
    int32_t r = uf.find(static_cast<int32_t>(i));
    if (remap[r] == 0) remap[r] = ++next;
    labels[i] = remap[r];
  }
  return next;
}

// Per-component pixel areas; areas must have room for n_components entries.
void tpusfm_ccl_areas(const int32_t* labels, int64_t n, int32_t n_components,
                      int64_t* areas) {
  std::memset(areas, 0, sizeof(int64_t) * n_components);
  for (int64_t i = 0; i < n; ++i) {
    if (labels[i] > 0) ++areas[labels[i] - 1];
  }
}

// Boundary marker: out[i] = 1 if labels[i] > 0 and any 4-neighbor differs.
void tpusfm_ccl_boundary(const int32_t* labels, int32_t h, int32_t w,
                         uint8_t* out) {
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = static_cast<int64_t>(y) * w + x;
      uint8_t b = 0;
      if (labels[i] > 0) {
        const int32_t l = labels[i];
        if (x == 0 || y == 0 || x + 1 == w || y + 1 == h) {
          b = 1;
        } else if (labels[i - 1] != l || labels[i + 1] != l ||
                   labels[i - w] != l || labels[i + w] != l) {
          b = 1;
        }
      }
      out[i] = b;
    }
  }
}

// Speckle filter: invalidate disparity pixels belonging to connected
// regions (|disp difference| <= max_diff defines connectivity) smaller than
// max_size. Mirrors cv::filterSpeckles semantics (StereoBM post-filter).
void tpusfm_filter_speckles(float* disp, uint8_t* valid, int32_t h, int32_t w,
                            float max_diff, int32_t max_size) {
  const int64_t n = static_cast<int64_t>(h) * w;
  UF uf(n);
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const int64_t i = static_cast<int64_t>(y) * w + x;
      if (!valid[i]) continue;
      if (x > 0 && valid[i - 1] &&
          std::abs(disp[i] - disp[i - 1]) <= max_diff)
        uf.unite(i, i - 1);
      if (y > 0 && valid[i - w] &&
          std::abs(disp[i] - disp[i - w]) <= max_diff)
        uf.unite(i, i - w);
    }
  }
  std::vector<int32_t> size(n, 0);
  for (int64_t i = 0; i < n; ++i)
    if (valid[i]) ++size[uf.find(static_cast<int32_t>(i))];
  for (int64_t i = 0; i < n; ++i) {
    if (valid[i] && size[uf.find(static_cast<int32_t>(i))] < max_size) {
      valid[i] = 0;
    }
  }
}

}  // extern "C"
