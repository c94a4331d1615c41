// Native BVH builder of the PyTorch port: the host-side tree construction.
//
// The port's own copy of the JAX package's cudaraytracer_tpu/native/
// bvh_builder.cpp (the port imports nothing of that package).  The
// reference builds its BVH with recursive device constructors +
// thrust::sort on a single CUDA thread (CudaTest/src/hitable/bvh.h:76-125).
// Here the build is a host-side concern (the card only refits and
// traverses flat arrays), so the native piece is a median-split builder
// emitting the same DFS-preorder skip-link layout as ops/bvh.py's Python
// builder: the same topology rules (sort by bbox-min along the chosen
// axis, n/2 split, 1-2 prim leaves), ~50-100x faster for large meshes.
//
// Exposed through a C ABI for ctypes; native/__init__.py builds it with g++
// at first use into the package's _build/ directory.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <random>
#include <vector>

namespace {

constexpr float kAabbPad = 1e-4f;  // ops/bvh.py AABB_PAD

struct Builder {
  const float* prim_min;  // [n][3]
  const float* prim_max;  // [n][3]
  std::vector<float> centroid;  // [n][3]
  int leaf_size;
  int axis_mode;  // 0 = largest extent, 1 = random (bvh.h:83 parity)
  std::mt19937 rng;

  // outputs
  float* bbox_min;
  float* bbox_max;
  uint8_t* is_leaf;
  int32_t* skip;
  int32_t* prim0;
  int32_t* prim1;
  int32_t* child_l;
  int32_t* child_r;
  int32_t* depth;
  int32_t n_nodes = 0;

  int emit(int32_t* span, int count, int d) {
    const int idx = n_nodes++;
    float lo[3] = {1e30f, 1e30f, 1e30f};
    float hi[3] = {-1e30f, -1e30f, -1e30f};
    for (int i = 0; i < count; ++i) {
      const float* pmin = prim_min + 3 * span[i];
      const float* pmax = prim_max + 3 * span[i];
      for (int k = 0; k < 3; ++k) {
        lo[k] = std::min(lo[k], pmin[k]);
        hi[k] = std::max(hi[k], pmax[k]);
      }
    }
    for (int k = 0; k < 3; ++k) {
      bbox_min[3 * idx + k] = lo[k] - kAabbPad;
      bbox_max[3 * idx + k] = hi[k] + kAabbPad;
    }
    depth[idx] = d;

    if (count <= leaf_size) {
      is_leaf[idx] = 1;
      prim0[idx] = span[0];
      prim1[idx] = span[count - 1];  // == span[0] for single-prim leaves
      child_l[idx] = -1;
      child_r[idx] = -1;
      return idx;
    }

    int axis;
    if (axis_mode == 1) {
      axis = static_cast<int>(rng() % 3);  // bvh.h:83 curand axis draw
    } else {
      float cmin[3] = {1e30f, 1e30f, 1e30f};
      float cmax[3] = {-1e30f, -1e30f, -1e30f};
      for (int i = 0; i < count; ++i) {
        const float* c = centroid.data() + 3 * span[i];
        for (int k = 0; k < 3; ++k) {
          cmin[k] = std::min(cmin[k], c[k]);
          cmax[k] = std::max(cmax[k], c[k]);
        }
      }
      axis = 0;
      float best = cmax[0] - cmin[0];
      for (int k = 1; k < 3; ++k) {
        if (cmax[k] - cmin[k] > best) {
          best = cmax[k] - cmin[k];
          axis = k;
        }
      }
    }

    // BoxCompare (bvh.h:9-45): sort span by bbox MIN along the axis (stable,
    // matching numpy's stable argsort in the Python builder).  NaN bounds
    // (degenerate input geometry) sort as +inf — numpy places NaN last, and
    // a raw `<` with NaN is not a strict weak ordering (UB in stable_sort).
    const float* pm = prim_min;
    std::stable_sort(span, span + count, [pm, axis](int32_t a, int32_t b) {
      float va = pm[3 * a + axis];
      float vb = pm[3 * b + axis];
      if (std::isnan(va)) va = std::numeric_limits<float>::infinity();
      if (std::isnan(vb)) vb = std::numeric_limits<float>::infinity();
      return va < vb;
    });

    is_leaf[idx] = 0;
    prim0[idx] = -1;
    prim1[idx] = -1;
    const int half = count / 2;  // bvh.h:111-112 n/2 split
    const int l = emit(span, half, d + 1);
    const int r = emit(span + half, count - half, d + 1);
    child_l[idx] = l;
    child_r[idx] = r;
    return idx;
  }

  void fill_skip(int idx, int after) {
    skip[idx] = after;
    if (!is_leaf[idx]) {
      fill_skip(child_l[idx], child_r[idx]);
      fill_skip(child_r[idx], after);
    }
  }
};

}  // namespace

extern "C" {

// Returns the node count (<= 2 * n_prims).  All output arrays must be sized
// for 2 * n_prims nodes; bbox arrays hold 3 floats per node.
int32_t crt_build_bvh(const float* prim_min, const float* prim_max,
                      int32_t n_prims, int32_t leaf_size, int32_t axis_mode,
                      uint32_t seed, float* bbox_min, float* bbox_max,
                      uint8_t* is_leaf, int32_t* skip, int32_t* prim0,
                      int32_t* prim1, int32_t* child_l, int32_t* child_r,
                      int32_t* depth) {
  if (n_prims <= 0) return 0;
  Builder b;
  b.prim_min = prim_min;
  b.prim_max = prim_max;
  b.leaf_size = leaf_size;
  b.axis_mode = axis_mode;
  b.rng.seed(seed);
  b.centroid.resize(3 * n_prims);
  for (int i = 0; i < 3 * n_prims; ++i) {
    b.centroid[i] = 0.5f * (prim_min[i] + prim_max[i]);
  }
  b.bbox_min = bbox_min;
  b.bbox_max = bbox_max;
  b.is_leaf = is_leaf;
  b.skip = skip;
  b.prim0 = prim0;
  b.prim1 = prim1;
  b.child_l = child_l;
  b.child_r = child_r;
  b.depth = depth;

  std::vector<int32_t> order(n_prims);
  for (int32_t i = 0; i < n_prims; ++i) order[i] = i;
  b.emit(order.data(), n_prims, 0);
  b.fill_skip(0, b.n_nodes);
  return b.n_nodes;
}

// Triangle bounds helper: lo/hi[i] = min/max of the three vertices.
void crt_triangle_bounds(const float* v0, const float* v1, const float* v2,
                         int32_t n, float* lo, float* hi) {
  for (int32_t i = 0; i < 3 * n; ++i) {
    const float a = v0[i], b = v1[i], c = v2[i];
    lo[i] = std::min(a, std::min(b, c));
    hi[i] = std::max(a, std::max(b, c));
  }
}

}  // extern "C"
