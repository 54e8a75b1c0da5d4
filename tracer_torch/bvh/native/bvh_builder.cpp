// Native BVH builder: median-split over primitive AABBs.
//
// C++ re-design of the reference host builder (include/bvh_builder.h:
// 52-120) with a C ABI for ctypes: the recursive median split via
// std::nth_element on the largest centroid-extent axis, one primitive
// per leaf, preorder-flattened node arrays. Unlike the reference, the
// split axis is stored in its own field (the reference overloads `type`,
// bvh.h:52 — see SURVEY.md §2 L3).
//
// A copy of tracer/bvh/native/bvh_builder.cpp for tracer_torch: the
// performance path for large scenes (2K+ primitives); tracer_torch/bvh/
// builder.py uses its NumPy builder on a host without g++.
//
// Built at first use by tracer_torch/bvh/native/__init__.py (g++, into
// build/tracer_torch/).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

struct Prim {
  float lo[3];
  float hi[3];
  float centroid[3];
  int32_t kind;
  int32_t index;
};

struct Builder {
  std::vector<Prim>* prims;
  float* out_box_min;
  float* out_box_max;
  int32_t* out_left;
  int32_t* out_right;
  int32_t* out_kind;
  int32_t* out_axis;
  int32_t next_node = 0;

  int32_t build(int32_t start, int32_t end) {
    const int32_t node = next_node++;
    auto& p = *prims;

    float bmin[3], bmax[3];
    for (int a = 0; a < 3; ++a) {
      bmin[a] = p[start].lo[a];
      bmax[a] = p[start].hi[a];
    }
    for (int32_t i = start + 1; i < end; ++i) {
      for (int a = 0; a < 3; ++a) {
        bmin[a] = std::min(bmin[a], p[i].lo[a]);
        bmax[a] = std::max(bmax[a], p[i].hi[a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      out_box_min[node * 3 + a] = bmin[a];
      out_box_max[node * 3 + a] = bmax[a];
    }

    if (end - start == 1) {  // leaf (bvh_builder.h:63-67)
      out_left[node] = -1;
      out_right[node] = p[start].index;
      out_kind[node] = p[start].kind;
      out_axis[node] = 0;
      return node;
    }

    // Largest centroid extent picks the axis (bvh_builder.h:75-87).
    float cmin[3], cmax[3];
    for (int a = 0; a < 3; ++a) {
      cmin[a] = cmax[a] = p[start].centroid[a];
    }
    for (int32_t i = start + 1; i < end; ++i) {
      for (int a = 0; a < 3; ++a) {
        cmin[a] = std::min(cmin[a], p[i].centroid[a]);
        cmax[a] = std::max(cmax[a], p[i].centroid[a]);
      }
    }
    int axis = 0;
    float best = cmax[0] - cmin[0];
    if (cmax[1] - cmin[1] > best) {
      best = cmax[1] - cmin[1];
      axis = 1;
    }
    if (cmax[2] - cmin[2] > best) {
      axis = 2;
    }

    const int32_t mid = (start + end) / 2;
    std::nth_element(
        p.begin() + start, p.begin() + mid, p.begin() + end,
        [axis](const Prim& a, const Prim& b) {
          return a.centroid[axis] < b.centroid[axis];
        });

    const int32_t left = build(start, mid);
    const int32_t right = build(mid, end);
    out_left[node] = left;
    out_right[node] = right;
    out_kind[node] = -1;
    out_axis[node] = axis;
    return node;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written (2*num_prims - 1), or 0 if empty.
// Output arrays must hold at least 2*num_prims - 1 entries.
int32_t tracer_build_bvh(int32_t num_prims, const float* lo, const float* hi,
                         const float* centroid, const int32_t* kind,
                         const int32_t* index, float* out_box_min,
                         float* out_box_max, int32_t* out_left,
                         int32_t* out_right, int32_t* out_kind,
                         int32_t* out_axis) {
  if (num_prims <= 0) return 0;
  std::vector<Prim> prims(num_prims);
  for (int32_t i = 0; i < num_prims; ++i) {
    for (int a = 0; a < 3; ++a) {
      prims[i].lo[a] = lo[i * 3 + a];
      prims[i].hi[a] = hi[i * 3 + a];
      prims[i].centroid[a] = centroid[i * 3 + a];
    }
    prims[i].kind = kind[i];
    prims[i].index = index[i];
  }
  Builder b{&prims,    out_box_min, out_box_max, out_left,
            out_right, out_kind,    out_axis};
  b.build(0, num_prims);
  return b.next_node;
}

}  // extern "C"
