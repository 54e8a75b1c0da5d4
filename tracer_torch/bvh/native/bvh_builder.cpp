// Native BVH builders over primitive AABBs: the median split, and the
// surface-area heuristic (SAH) split that tracer_torch builds its trees by.
//
// tracer_build_bvh is a copy of tracer/bvh/native/bvh_builder.cpp: a C++
// re-design of the reference host builder (include/bvh_builder.h:
// 52-120) with a C ABI for ctypes: the recursive median split via
// std::nth_element on the largest centroid-extent axis, one primitive
// per leaf, preorder-flattened node arrays. Unlike the reference, the
// split axis is stored in its own field (the reference overloads `type`,
// bvh.h:52 — see SURVEY.md §2 L3).
//
// tracer_build_bvh_sah splits each node where area(L)|L| + area(R)|R| is
// least, over every split point of the node's centroids sorted on each
// axis (ties by primitive position), the costs in double; the first least
// cost in the order axis 0, 1, 2, then left count 1 .. n-1 wins. A node
// whose depth (root 1) plus ceil(log2(its primitive count)) reaches
// max_depth takes the median split of its sorted centroids on the axis of
// largest centroid extent instead, so no tree is deeper than max_depth.
// Both builders keep one primitive per leaf, 2P - 1 nodes in preorder
// (left == node + 1) and the split axis in `axis`.
// tracer_torch/bvh/builder.py:build_bvh_sah_numpy is its NumPy twin: the
// same order and the same costs, so the same arrays (the build runs with
// -ffp-contract=off, so no product is fused into a sum).
//
// Built at first use by tracer_torch/bvh/native/__init__.py (g++, into
// build/tracer_torch/); tracer_torch/bvh/builder.py uses the NumPy
// builders on a host without g++.

#include <algorithm>
#include <cstdint>
#include <limits>
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

// Surface area over two (the half is common to every cost), in double.
double half_area(const float* lo, const float* hi) {
  const double dx = (double)hi[0] - (double)lo[0];
  const double dy = (double)hi[1] - (double)lo[1];
  const double dz = (double)hi[2] - (double)lo[2];
  return dx * dy + dy * dz + dz * dx;
}

int ceil_log2(int32_t n) {
  int k = 0;
  while ((int64_t{1} << k) < n) ++k;
  return k;
}

struct SahBuilder {
  const std::vector<Prim>* prims;
  int32_t max_depth;
  float* out_box_min;
  float* out_box_max;
  int32_t* out_left;
  int32_t* out_right;
  int32_t* out_kind;
  int32_t* out_axis;
  int32_t next_node = 0;

  // `items`: positions in *prims of the node's primitives
  int32_t build(const std::vector<int32_t>& items, int32_t depth) {
    const int32_t node = next_node++;
    const auto& p = *prims;
    const int32_t n = (int32_t)items.size();

    float bmin[3], bmax[3];
    for (int a = 0; a < 3; ++a) {
      bmin[a] = p[items[0]].lo[a];
      bmax[a] = p[items[0]].hi[a];
    }
    for (int32_t i = 1; i < n; ++i) {
      for (int a = 0; a < 3; ++a) {
        bmin[a] = std::min(bmin[a], p[items[i]].lo[a]);
        bmax[a] = std::max(bmax[a], p[items[i]].hi[a]);
      }
    }
    for (int a = 0; a < 3; ++a) {
      out_box_min[node * 3 + a] = bmin[a];
      out_box_max[node * 3 + a] = bmax[a];
    }

    if (n == 1) {
      const Prim& leaf = p[items[0]];
      out_left[node] = -1;
      out_right[node] = leaf.index;
      out_kind[node] = leaf.kind;
      out_axis[node] = 0;
      return node;
    }

    std::vector<int32_t> sorted[3];
    for (int a = 0; a < 3; ++a) {
      sorted[a] = items;
      std::sort(sorted[a].begin(), sorted[a].end(), [&p, a](int32_t x, int32_t y) {
        const float cx = p[x].centroid[a], cy = p[y].centroid[a];
        return cx < cy || (!(cy < cx) && x < y);
      });
    }

    int axis = 0;
    int32_t count = n / 2;  // primitives on the left
    if (depth + ceil_log2(n) >= max_depth) {
      // the depth guard: the median on the largest centroid extent
      float cmin[3], cmax[3];
      for (int a = 0; a < 3; ++a) {
        cmin[a] = p[sorted[a][0]].centroid[a];
        cmax[a] = p[sorted[a][n - 1]].centroid[a];
      }
      float best = cmax[0] - cmin[0];
      for (int a = 1; a < 3; ++a) {
        if (cmax[a] - cmin[a] > best) {
          best = cmax[a] - cmin[a];
          axis = a;
        }
      }
    } else {
      std::vector<float> suffix_lo(3 * n), suffix_hi(3 * n);
      double best = std::numeric_limits<double>::infinity();
      for (int a = 0; a < 3; ++a) {
        const std::vector<int32_t>& s = sorted[a];
        for (int c = 0; c < 3; ++c) {
          suffix_lo[3 * (n - 1) + c] = p[s[n - 1]].lo[c];
          suffix_hi[3 * (n - 1) + c] = p[s[n - 1]].hi[c];
        }
        for (int32_t i = n - 2; i >= 1; --i) {
          for (int c = 0; c < 3; ++c) {
            suffix_lo[3 * i + c] = std::min(suffix_lo[3 * (i + 1) + c], p[s[i]].lo[c]);
            suffix_hi[3 * i + c] = std::max(suffix_hi[3 * (i + 1) + c], p[s[i]].hi[c]);
          }
        }
        float lo[3], hi[3];
        for (int c = 0; c < 3; ++c) {
          lo[c] = p[s[0]].lo[c];
          hi[c] = p[s[0]].hi[c];
        }
        for (int32_t i = 1; i < n; ++i) {  // i primitives on the left
          const double cost = half_area(lo, hi) * (double)i +
                              half_area(&suffix_lo[3 * i], &suffix_hi[3 * i]) * (double)(n - i);
          if (cost < best) {
            best = cost;
            axis = a;
            count = i;
          }
          for (int c = 0; c < 3; ++c) {
            lo[c] = std::min(lo[c], p[s[i]].lo[c]);
            hi[c] = std::max(hi[c], p[s[i]].hi[c]);
          }
        }
      }
    }

    const std::vector<int32_t>& s = sorted[axis];
    const int32_t left = build(std::vector<int32_t>(s.begin(), s.begin() + count), depth + 1);
    const int32_t right = build(std::vector<int32_t>(s.begin() + count, s.end()), depth + 1);
    out_left[node] = left;
    out_right[node] = right;
    out_kind[node] = -1;
    out_axis[node] = axis;
    return node;
  }
};

std::vector<Prim> read_prims(int32_t num_prims, const float* lo, const float* hi,
                             const float* centroid, const int32_t* kind,
                             const int32_t* index) {
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
  return prims;
}

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
  std::vector<Prim> prims = read_prims(num_prims, lo, hi, centroid, kind, index);
  Builder b{&prims,    out_box_min, out_box_max, out_left,
            out_right, out_kind,    out_axis};
  b.build(0, num_prims);
  return b.next_node;
}

// The SAH builder, same contract; no tree it writes is deeper than
// max_depth (root 1), which must be at least ceil(log2(num_prims)) + 1.
int32_t tracer_build_bvh_sah(int32_t num_prims, const float* lo, const float* hi,
                             const float* centroid, const int32_t* kind,
                             const int32_t* index, int32_t max_depth,
                             float* out_box_min, float* out_box_max,
                             int32_t* out_left, int32_t* out_right,
                             int32_t* out_kind, int32_t* out_axis) {
  if (num_prims <= 0) return 0;
  std::vector<Prim> prims = read_prims(num_prims, lo, hi, centroid, kind, index);
  std::vector<int32_t> items(num_prims);
  for (int32_t i = 0; i < num_prims; ++i) items[i] = i;
  SahBuilder b{&prims,   max_depth, out_box_min, out_box_max,
               out_left, out_right, out_kind,    out_axis};
  b.build(items, 1);
  return b.next_node;
}

}  // extern "C"
