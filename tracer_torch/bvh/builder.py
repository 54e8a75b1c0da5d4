"""Host-side BVH construction, one primitive per leaf, flattened in
preorder: the median split (port of tracer/bvh/builder.py; reference
`build_bvh`, include/bvh_builder.h:52-120) and the surface-area heuristic
(SAH) split, which `build_bvh_arrays`, and so every scene built with its
BVH, takes.

`build_bvh_numpy` is copied from tracer's as it is, so that the two
packages build bit-identical median trees from the same primitives.
Internal nodes store the real split axis in a field of their own (the
reference reads `type` as the axis, bvh.h:52, which is -1 there). The left
subtree is allocated first, so an internal node's left child is the next
node (`left == node + 1`), which the kernel's node records rely on.

The SAH builder splits each node where area(left) x |left| + area(right) x
|right| is least, over every split of its centroids sorted on each axis:
a primitive whose box dwarfs the rest (the RTIOW ground sphere, the
field's floor) ends up next to the root instead of under a chain of
scene-wide boxes, and a field of like-sized primitives splits near the
median. Its trees are deeper than a median tree; a node whose depth plus
ceil(log2(its primitive count)) reaches `BVH_STACK` takes the median split,
so that no tree is deeper than the traversals' stack. The native C++
builder (tracer_torch/bvh/native, built with g++ at first use) is used when
available, `build_bvh_sah_numpy` on a host without g++: the same order and
the same float64 costs, so the same arrays. The arrays go to the scene's
device as tensors.
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np
import torch

from tracer_torch.geometry import aabb as aabb_mod
from tracer_torch.scene.types import BVHArrays
from tracer_torch.utils import profiling

KIND_SPHERE = 0  # bvh_builder.h:108 (type 0)
KIND_PLANE = 1  # bvh_builder.h:114 (type 1)
KIND_INTERNAL = -1  # bvh_builder.h:94
# The deepest tree (root 1) a traversal takes: K1-bvh's per-thread stack
# (BVH_STACK in csrc/megakernel.cu), which the plain traversal's caps too.
BVH_STACK = 32


def primitive_boxes(sphere_center, sphere_radius, plane_base, plane_u, plane_v, plane_type,
                    sphere_motion=None):
    """AABBs + centroids for all primitives, spheres first then planes
    (bvh_builder.h:99-117). Returns (lo, hi, centroid, kind, index).
    `sphere_motion` (`[S, 3]` or None): a sphere that moves (a nonzero
    row) takes the union of its boxes at times 0 and 1 (book 2's
    moving_sphere::bounding_box), and that box's centre as its centroid;
    every other primitive keeps its box and centroid."""
    parts_lo, parts_hi, cents, kinds, idxs = [], [], [], [], []
    ns = len(sphere_radius)
    if ns:
        center = np.asarray(sphere_center, np.float32)
        radius = np.asarray(sphere_radius, np.float32)
        lo, hi = aabb_mod.sphere_boxes(center, radius)
        cent = center  # bvh_builder.h:105
        if sphere_motion is not None:
            moves = np.any(np.asarray(sphere_motion) != 0, axis=1)
            lo1, hi1 = aabb_mod.sphere_boxes(center + np.asarray(sphere_motion, np.float32),
                                             radius)
            lo = np.where(moves[:, None], np.minimum(lo, lo1), lo)
            hi = np.where(moves[:, None], np.maximum(hi, hi1), hi)
            cent = np.where(moves[:, None], (lo + hi) * np.float32(0.5), center)
        parts_lo.append(lo)
        parts_hi.append(hi)
        cents.append(cent)
        kinds.append(np.full(ns, KIND_SPHERE, np.int32))
        idxs.append(np.arange(ns, dtype=np.int32))
    np_ = len(plane_type)
    if np_:
        base = np.asarray(plane_base, np.float32)
        u = np.asarray(plane_u, np.float32)
        v = np.asarray(plane_v, np.float32)
        lo, hi = aabb_mod.plane_boxes(base, u, v, np.asarray(plane_type))
        parts_lo.append(lo)
        parts_hi.append(hi)
        cents.append(base + (u + v) * 0.5)  # approx centroid, bvh_builder.h:112
        kinds.append(np.full(np_, KIND_PLANE, np.int32))
        idxs.append(np.arange(np_, dtype=np.int32))
    if not parts_lo:
        z = np.zeros((0, 3), np.float32)
        return z, z, z, np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (
        np.concatenate(parts_lo),
        np.concatenate(parts_hi),
        np.concatenate(cents),
        np.concatenate(kinds),
        np.concatenate(idxs),
    )


def build_bvh_numpy(lo, hi, centroid, kind, index) -> Tuple[np.ndarray, ...]:
    """Median-split BVH over pre-boxed primitives.

    Returns flat arrays (box_min[N,3], box_max[N,3], left[N], right[N],
    node_kind[N], axis[N]) in preorder, root at 0. N = 2*P - 1.
    """
    num = len(kind)
    if num == 0:
        z3 = np.zeros((0, 3), np.float32)
        zi = np.zeros(0, np.int32)
        return z3, z3, zi, zi, zi, zi

    order = np.arange(num)
    nodes_min, nodes_max = [], []
    nodes_left, nodes_right, nodes_kind, nodes_axis = [], [], [], []

    def alloc():
        nodes_min.append(None)
        nodes_max.append(None)
        nodes_left.append(0)
        nodes_right.append(0)
        nodes_kind.append(0)
        nodes_axis.append(0)
        return len(nodes_min) - 1

    def rec(start: int, end: int) -> int:
        node = alloc()
        sel = order[start:end]
        nodes_min[node] = lo[sel].min(axis=0)
        nodes_max[node] = hi[sel].max(axis=0)
        if end - start == 1:
            p = order[start]
            nodes_left[node] = -1  # bvh_builder.h:65
            nodes_right[node] = int(index[p])
            nodes_kind[node] = int(kind[p])
            nodes_axis[node] = 0
            return node
        c = centroid[sel]
        extent = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(extent))  # largest extent (bvh_builder.h:78-87)
        mid = (start + end) // 2
        # nth_element partition on the centroid along `axis` (bvh_builder.h:84-86)
        part = np.argpartition(c[:, axis], mid - start)
        order[start:end] = sel[part]
        left = rec(start, mid)
        right = rec(mid, end)
        nodes_left[node] = left
        nodes_right[node] = right
        nodes_kind[node] = KIND_INTERNAL
        nodes_axis[node] = axis
        return node

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * num + 100))
    try:
        rec(0, num)
    finally:
        sys.setrecursionlimit(old_limit)

    return (
        np.stack(nodes_min).astype(np.float32),
        np.stack(nodes_max).astype(np.float32),
        np.asarray(nodes_left, np.int32),
        np.asarray(nodes_right, np.int32),
        np.asarray(nodes_kind, np.int32),
        np.asarray(nodes_axis, np.int32),
    )


def _half_areas(lo, hi):
    """Surface areas over two of [n, 3] boxes, in float64, in the native
    builder's order of operations."""
    d = hi.astype(np.float64) - lo.astype(np.float64)
    return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]


def build_bvh_sah_numpy(lo, hi, centroid, kind, index) -> Tuple[np.ndarray, ...]:
    """SAH BVH over pre-boxed primitives (module note), the same arrays as
    the native `tracer_build_bvh_sah`: each node's primitives sorted by
    centroid on each axis, ties by position; the first least cost in the
    order axis 0, 1, 2, then left count 1 .. n - 1; the depth guard's
    median on the first axis of largest centroid extent. Returns
    build_bvh_numpy's arrays; no tree is deeper than `BVH_STACK`."""
    num = len(kind)
    n_nodes = max(2 * num - 1, 0)
    box_min = np.zeros((n_nodes, 3), np.float32)
    box_max = np.zeros((n_nodes, 3), np.float32)
    left = np.zeros(n_nodes, np.int32)
    right = np.zeros(n_nodes, np.int32)
    nkind = np.zeros(n_nodes, np.int32)
    axis = np.zeros(n_nodes, np.int32)
    next_node = 0

    def rec(items, depth):
        nonlocal next_node
        node = next_node
        next_node += 1
        box_min[node] = lo[items].min(axis=0)
        box_max[node] = hi[items].max(axis=0)
        n = len(items)
        if n == 1:
            left[node], right[node], nkind[node] = -1, index[items[0]], kind[items[0]]
            return node
        orders = [items[np.lexsort((items, centroid[items, a]))] for a in range(3)]
        if depth + int(n - 1).bit_length() >= BVH_STACK:  # ceil(log2(n))
            c = centroid[items]
            a, count = int(np.argmax(c.max(axis=0) - c.min(axis=0))), n // 2
        else:
            costs = np.empty((3, n - 1))
            on_left = np.arange(1, n)
            for a, o in enumerate(orders):
                pre_lo, pre_hi = np.minimum.accumulate(lo[o]), np.maximum.accumulate(hi[o])
                suf_lo = np.minimum.accumulate(lo[o][::-1])[::-1]
                suf_hi = np.maximum.accumulate(hi[o][::-1])[::-1]
                costs[a] = (_half_areas(pre_lo[:-1], pre_hi[:-1]) * on_left
                            + _half_areas(suf_lo[1:], suf_hi[1:]) * (n - on_left))
            a, count = divmod(int(np.argmin(costs)), n - 1)
            count += 1
        left[node] = rec(orders[a][:count], depth + 1)
        right[node] = rec(orders[a][count:], depth + 1)
        nkind[node], axis[node] = KIND_INTERNAL, a
        return node

    if num:
        rec(np.arange(num), 1)
    return box_min, box_max, left, right, nkind, axis


def tree_depth(left, right) -> int:
    """Max root-to-leaf depth (root = 1) from the flat node arrays.

    Nodes are in preorder, so every child index is larger than its
    parent's — one forward pass suffices.
    """
    left = np.asarray(left)
    right = np.asarray(right)
    n = len(left)
    if n == 0:
        return 0
    depth = np.zeros(n, np.int64)
    depth[0] = 1
    maxd = 1
    for i in range(n):
        if left[i] >= 0:  # internal node
            d = depth[i] + 1
            depth[left[i]] = d
            depth[right[i]] = d
            if d > maxd:
                maxd = int(d)
    return maxd


def check_stack_capacity(left, right) -> None:
    """Fail loudly if a traversal's stack cannot hold this tree: the
    near-first walks hold at most the tree's depth, and K1-bvh's stack,
    which the plain traversal's caps too, holds `BVH_STACK` entries."""
    d = tree_depth(left, right)
    if d > BVH_STACK:
        raise ValueError(
            f"BVH tree depth {d} exceeds the traversal stack capacity {BVH_STACK} "
            f"(BVH_STACK in tracer_torch/bvh/builder.py and csrc/megakernel.cu)."
        )


def native_available() -> bool:
    """Whether `build_bvh_arrays` takes the native builder on this host."""
    from tracer_torch.bvh import native

    return native.available()


def _build(lo, hi, centroid, kind, index):
    """The SAH tree: the native C++ builder when available, else NumPy."""
    if native_available():
        from tracer_torch.bvh import native

        return native.build_bvh_sah(lo, hi, centroid, kind, index)
    return build_bvh_sah_numpy(lo, hi, centroid, kind, index)


def build_bvh_arrays(sphere_center, sphere_radius, plane_base, plane_u, plane_v, plane_type,
                     device, sphere_motion=None) -> BVHArrays:
    """Primitives -> boxes -> flat BVH, as tensors on `device`; a moving
    sphere's box covers its sweep (primitive_boxes)."""
    with profiling.span("tracer.bvh.build"):
        lo, hi, cent, kind, index = primitive_boxes(
            sphere_center, sphere_radius, plane_base, plane_u, plane_v, plane_type,
            sphere_motion=sphere_motion
        )
        bmin, bmax, left, right, nkind, axis = _build(lo, hi, cent, kind, index)
        check_stack_capacity(left, right)
        return BVHArrays(*(torch.tensor(a, device=device)
                           for a in (bmin, bmax, left, right, nkind, axis)))


def build_scene_bvh(buf, device) -> BVHArrays:
    """Build from a SceneBuffers (tracer_torch.scene.builders)."""
    return build_bvh_arrays(
        np.stack(buf.sphere_center) if buf.sphere_center else np.zeros((0, 3), np.float32),
        np.asarray(buf.sphere_radius, np.float32),
        np.stack(buf.plane_base) if buf.plane_base else np.zeros((0, 3), np.float32),
        np.stack(buf.plane_u) if buf.plane_u else np.zeros((0, 3), np.float32),
        np.stack(buf.plane_v) if buf.plane_v else np.zeros((0, 3), np.float32),
        np.asarray(buf.plane_type, np.int32),
        device,
        sphere_motion=buf.motion_array(),
    )


def build_scene_bvh_from_scene(scene) -> BVHArrays:
    """Build from a Scene's own primitives (read back to the host), on the
    scene's device: for scenes made without SceneBuffers."""
    sp, pl = scene.spheres, scene.planes
    host = lambda t: t.detach().cpu().numpy()
    return build_bvh_arrays(host(sp.center), host(sp.radius), host(pl.base), host(pl.u),
                            host(pl.v), host(pl.ptype), scene.device,
                            sphere_motion=None if scene.motion is None else host(scene.motion))
