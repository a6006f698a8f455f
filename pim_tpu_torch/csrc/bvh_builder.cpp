// Binned-SAH BVH builder of the port (host side, C++; built with g++ by
// pim_tpu_torch/native.py, bound through ctypes).
//
// A copy of pim_tpu/native/bvh_builder.cpp, line for line below this
// comment, so that on the same host CPU and with the same flags both
// packages build the same tree: the `bvh` backend's ties depend on it.
// Output is the flat layout of pim_tpu_torch/geom/bvh.py BvhArrays:
//
//   node_lo/hi [Nn,3]  AABBs
//   node_a     [Nn]    internal: left-child index;  leaf: first tri slot
//   node_b     [Nn]    internal: right-child index; leaf: ~(count)
//   tri_order  [T]     triangle permutation (leaf slots contiguous)
//
// A node is a leaf iff node_b < 0.  Children are emitted depth-first with
// the left child allocated immediately after its parent.  The semantics
// are those of geom/bvh.py:build_bvh_numpy (16-bin SAH over the longest
// centroid axis, median fallback on degenerate extents), but the arrays
// differ: this builder partitions in place (std::partition,
// std::nth_element), the numpy one keeps the input order.
//
// C ABI:
//   pim_bvh_build(positions, tri_count, max_leaf) -> opaque handle
//   pim_bvh_counts(handle, &node_count, &tri_count)
//   pim_bvh_export(handle, node_lo, node_hi, node_a, node_b, tri_order)
//   pim_bvh_free(handle)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct AABB {
  float lo[3];
  float hi[3];
  void reset() {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::numeric_limits<float>::infinity();
      hi[a] = -std::numeric_limits<float>::infinity();
    }
  }
  void grow(const AABB& o) {
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], o.lo[a]);
      hi[a] = std::max(hi[a], o.hi[a]);
    }
  }
  float half_area() const {
    float dx = std::max(hi[0] - lo[0], 0.0f);
    float dy = std::max(hi[1] - lo[1], 0.0f);
    float dz = std::max(hi[2] - lo[2], 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  std::vector<AABB> tri_box;       // [T]
  std::vector<float> centroid;     // [T*3]
  std::vector<int32_t> tri_order;  // filled leaf-by-leaf
  std::vector<float> node_lo, node_hi;  // [Nn*3]
  std::vector<int32_t> node_a, node_b;
  int max_leaf = 4;

  int32_t new_node() {
    node_lo.insert(node_lo.end(), 3, 0.0f);
    node_hi.insert(node_hi.end(), 3, 0.0f);
    node_a.push_back(0);
    node_b.push_back(0);
    return static_cast<int32_t>(node_a.size()) - 1;
  }

  // Partition idx[begin,end) in place; returns the split point or -1 for
  // "make a leaf".
  int64_t try_split(std::vector<int32_t>& idx, int64_t begin, int64_t end) {
    const int64_t n = end - begin;
    // centroid bounds
    float clo[3], chi[3];
    for (int a = 0; a < 3; ++a) {
      clo[a] = std::numeric_limits<float>::infinity();
      chi[a] = -std::numeric_limits<float>::infinity();
    }
    for (int64_t i = begin; i < end; ++i) {
      const float* c = &centroid[3 * idx[i]];
      for (int a = 0; a < 3; ++a) {
        clo[a] = std::min(clo[a], c[a]);
        chi[a] = std::max(chi[a], c[a]);
      }
    }
    int axis = 0;
    float ext = -1.0f;
    for (int a = 0; a < 3; ++a) {
      if (chi[a] - clo[a] > ext) {
        ext = chi[a] - clo[a];
        axis = a;
      }
    }
    if (ext < 1e-12f) {
      if (n > max_leaf) {
        // median split on the longest axis (all centroids equal -> any order)
        std::nth_element(idx.begin() + begin, idx.begin() + begin + n / 2,
                         idx.begin() + end);
        return begin + n / 2;
      }
      return -1;
    }

    const float scale = kNumBins * (1.0f - 1e-6f) / ext;
    int64_t counts[kNumBins] = {0};
    AABB bbox[kNumBins];
    for (auto& b : bbox) b.reset();
    for (int64_t i = begin; i < end; ++i) {
      int b = static_cast<int>((centroid[3 * idx[i] + axis] - clo[axis]) * scale);
      b = std::min(b, kNumBins - 1);
      counts[b]++;
      bbox[b].grow(tri_box[idx[i]]);
    }

    // suffix sweep (right side), then prefix sweep picking the best split
    float rarea[kNumBins];
    int64_t rcount[kNumBins];
    AABB acc;
    acc.reset();
    int64_t cnt = 0;
    for (int b = kNumBins - 1; b >= 1; --b) {
      acc.grow(bbox[b]);
      cnt += counts[b];
      rarea[b] = acc.half_area();
      rcount[b] = cnt;
    }
    acc.reset();
    cnt = 0;
    float best_cost = std::numeric_limits<float>::infinity();
    int best = -1;
    for (int b = 0; b < kNumBins - 1; ++b) {
      acc.grow(bbox[b]);
      cnt += counts[b];
      if (cnt == 0 || rcount[b + 1] == 0) continue;
      const float cost = acc.half_area() * cnt + rarea[b + 1] * rcount[b + 1];
      if (cost < best_cost) {
        best_cost = cost;
        best = b;
      }
    }
    if (best < 0) return -1;
    if (n <= max_leaf) {
      AABB whole;
      whole.reset();
      for (int64_t i = begin; i < end; ++i) whole.grow(tri_box[idx[i]]);
      if (best_cost >= whole.half_area() * n) return -1;
    }
    auto mid_it = std::partition(
        idx.begin() + begin, idx.begin() + end, [&](int32_t t) {
          int b = static_cast<int>((centroid[3 * t + axis] - clo[axis]) * scale);
          return std::min(b, kNumBins - 1) <= best;
        });
    int64_t mid = mid_it - idx.begin();
    if (mid == begin || mid == end) {  // numerical corner: force median
      mid = begin + n / 2;
    }
    return mid;
  }

  void build(const float* positions, int64_t tri_count) {
    tri_box.resize(tri_count);
    centroid.resize(tri_count * 3);
    for (int64_t t = 0; t < tri_count; ++t) {
      AABB& b = tri_box[t];
      b.reset();
      for (int v = 0; v < 3; ++v) {
        const float* p = positions + (t * 3 + v) * 3;
        for (int a = 0; a < 3; ++a) {
          b.lo[a] = std::min(b.lo[a], p[a]);
          b.hi[a] = std::max(b.hi[a], p[a]);
        }
      }
      for (int a = 0; a < 3; ++a)
        centroid[3 * t + a] = 0.5f * (b.lo[a] + b.hi[a]);
    }

    std::vector<int32_t> idx(tri_count);
    for (int64_t i = 0; i < tri_count; ++i) idx[i] = static_cast<int32_t>(i);
    tri_order.reserve(tri_count);
    node_a.reserve(tri_count / 2 + 8);

    struct Item {
      int32_t node;
      int64_t begin, end;
    };
    std::vector<Item> stack;
    const int32_t root = new_node();
    stack.push_back({root, 0, tri_count});
    while (!stack.empty()) {
      const Item it = stack.back();
      stack.pop_back();
      AABB box;
      box.reset();
      for (int64_t i = it.begin; i < it.end; ++i) box.grow(tri_box[idx[i]]);
      std::memcpy(&node_lo[3 * it.node], box.lo, sizeof box.lo);
      std::memcpy(&node_hi[3 * it.node], box.hi, sizeof box.hi);

      int64_t mid = -1;
      if (it.end - it.begin > max_leaf) {
        mid = try_split(idx, it.begin, it.end);
        if (mid < 0) mid = it.begin + (it.end - it.begin) / 2;
      }
      if (mid < 0) {
        node_a[it.node] = static_cast<int32_t>(tri_order.size());
        node_b[it.node] = ~static_cast<int32_t>(it.end - it.begin);
        tri_order.insert(tri_order.end(), idx.begin() + it.begin,
                         idx.begin() + it.end);
      } else {
        const int32_t li = new_node();
        const int32_t ri = new_node();
        node_a[it.node] = li;
        node_b[it.node] = ri;
        // left pushed last => popped first => left == parent+1 emission
        stack.push_back({ri, mid, it.end});
        stack.push_back({li, it.begin, mid});
      }
    }
  }
};

}  // namespace

extern "C" {

void* pim_bvh_build(const float* positions, int64_t tri_count, int max_leaf) {
  auto* b = new Builder();
  b->max_leaf = max_leaf < 1 ? 1 : max_leaf;
  if (tri_count <= 0) {
    b->new_node();
    b->node_b[0] = ~0;
  } else {
    b->build(positions, tri_count);
  }
  return b;
}

void pim_bvh_counts(void* handle, int64_t* node_count, int64_t* tri_count) {
  auto* b = static_cast<Builder*>(handle);
  *node_count = static_cast<int64_t>(b->node_a.size());
  *tri_count = static_cast<int64_t>(b->tri_order.size());
}

void pim_bvh_export(void* handle, float* node_lo, float* node_hi,
                    int32_t* node_a, int32_t* node_b, int32_t* tri_order) {
  auto* b = static_cast<Builder*>(handle);
  std::memcpy(node_lo, b->node_lo.data(), b->node_lo.size() * sizeof(float));
  std::memcpy(node_hi, b->node_hi.data(), b->node_hi.size() * sizeof(float));
  std::memcpy(node_a, b->node_a.data(), b->node_a.size() * sizeof(int32_t));
  std::memcpy(node_b, b->node_b.data(), b->node_b.size() * sizeof(int32_t));
  std::memcpy(tri_order, b->tri_order.data(),
              b->tri_order.size() * sizeof(int32_t));
}

void pim_bvh_free(void* handle) { delete static_cast<Builder*>(handle); }

}  // extern "C"
