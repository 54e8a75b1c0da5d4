"""Primitive clusters for the cluster-culled megakernel (port of
tracer/pallas/cluster.py).

Primitives are grouped into spatially coherent clusters of at most K by a
recursive largest-axis median split on their centroids, the same rule as
tracer's (`_median_split_tree` runs the recursion of its
`_median_split_clusters`, so the same centroids give the same groups). A
ray tests the primitives of the clusters whose box it may hit: the plain
version (`render/hit.py:hit_scene_clustered`) slab-tests every box, the
kernel (`csrc/megakernel.cu:trace_kernel<CLUSTERED>`) walks the split's
tree.

`ClusterTables` holds only the clustering: each cluster's box, the
original primitive index of each of its K slots, and the split's binary
tree. The recursion is that tree: its leaves, in depth-first order with
the lower half first, are the clusters in ascending id, and an internal
node's box is the exact min/max of its children's. `nodes` lists the
2C - 1 nodes in that preorder, each as two float4 records, (lo x, y, z,
skip) and (hi x, y, z, cluster id), with the skip (the index of the node
after the subtree) and the id (-1 for an internal node) stored as int32
bits. The kernel reads geometry and materials from
`kernels/pack.py:pack_scene`'s tables through the slot indices, so the
bf16 hi/lo projection rows and the per-slot material copies of tracer's
`pack_clustered` (matrix-unit mechanics) have no counterpart. Since the
tables hold no materials, a material change with unchanged geometry
cannot render with stale materials, as it can through tracer's table
cache (keyed by geometry, holding materials).

The tables are cached per k for the scene's geometry tensors themselves
(`utils/tensor_cache.py:cached`, key `("cluster", k)`), while those live
and are not changed in place (a change bumps their `_version`). A cached
lookup reads nothing from the device, so a render on the card does not
wait for the stream; a new scene with the same geometry builds its tables
again, from a host copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tracer_torch.geometry import aabb as aabb_mod
from tracer_torch.scene.types import Scene
from tracer_torch.utils.tensor_cache import cached


class ClusterTables(NamedTuple):
    boxes: torch.Tensor  # [6, C] float32: lo x, y, z, hi x, y, z of each cluster
    slots: torch.Tensor  # [C*K] int32: primitive index (spheres first), -1 for padding
    nodes: torch.Tensor  # [2C-1, 2, 4] float32 records of the split's tree, in preorder
    num_clusters: int
    k: int


def check_k(cluster_k) -> int:
    """`cluster_k` as the renderers take it: an int >= 0 (0 = brute force)."""
    if isinstance(cluster_k, bool) or not isinstance(cluster_k, int) or cluster_k < 0:
        raise ValueError(f"cluster_k must be an int >= 0, got {cluster_k!r}")
    return cluster_k


def _median_split_tree(centroids: np.ndarray, k: int):
    """(groups, nodes) of the recursive largest-axis median split into
    index groups of <= k: `nodes` lists the recursion's calls in preorder,
    lower half first, each as the range [first, end) of the groups it
    made."""
    groups, nodes = [], []

    def rec(idx):
        at, first = len(nodes), len(groups)
        nodes.append(None)
        if len(idx) <= k:
            groups.append(idx)
        else:
            c = centroids[idx]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            mid = len(idx) // 2
            part = np.argpartition(c[:, axis], mid)
            rec(idx[part[:mid]])
            rec(idx[part[mid:]])
        nodes[at] = (first, len(groups))

    rec(np.arange(len(centroids)))
    return groups, nodes


def _node_records(boxes: np.ndarray, nodes: list) -> np.ndarray:
    """`[len(nodes), 2, 4]` float32 records of the tree (see the module
    note): a node over clusters [first, end) spans 2 (end - first) - 1
    nodes of the preorder."""
    rec = np.zeros((len(nodes), 2, 4), np.float32)
    bits = rec.view(np.int32)
    for i, (first, end) in enumerate(nodes):
        rec[i, 0, :3] = boxes[0:3, first:end].min(axis=1)
        rec[i, 1, :3] = boxes[3:6, first:end].max(axis=1)
        bits[i, 0, 3] = i + 2 * (end - first) - 1
        bits[i, 1, 3] = first if end - first == 1 else -1
    return rec


def _geometry(scene: Scene):
    """The tensors the clustering reads."""
    sp, pl = scene.spheres, scene.planes
    return sp.center, sp.radius, pl.base, pl.u, pl.v, pl.ptype


def _build(tensors, k: int, device) -> ClusterTables:
    center, radius, base, u, v, ptype = (t.detach().cpu().numpy() for t in tensors)
    num_s, num_p = center.shape[0], base.shape[0]
    n = num_s + num_p
    centroid = np.zeros((n, 3), np.float32)
    lo = np.zeros((n, 3), np.float32)
    hi = np.zeros((n, 3), np.float32)
    if num_s:
        centroid[:num_s] = center
        lo[:num_s], hi[:num_s] = aabb_mod.sphere_boxes(center, radius)
    if num_p:
        centroid[num_s:] = base + (u + v) * 0.5
        lo[num_s:], hi[num_s:] = aabb_mod.plane_boxes(base, u, v, ptype)
    groups, nodes = _median_split_tree(centroid, k)
    boxes = np.zeros((6, len(groups)), np.float32)
    slots = np.full((len(groups), k), -1, np.int32)
    for ci, idx in enumerate(groups):
        slots[ci, :len(idx)] = idx
        boxes[0:3, ci] = lo[idx].min(axis=0)
        boxes[3:6, ci] = hi[idx].max(axis=0)
    return ClusterTables(torch.tensor(boxes, device=device),
                         torch.tensor(slots.reshape(-1), device=device),
                         torch.tensor(_node_records(boxes, nodes), device=device), len(groups), k)


def pack_clustered(scene: Scene, k: int = 16) -> ClusterTables:
    """The cluster tables of `scene` for clusters of at most `k`
    primitives, on the scene's device (cached per geometry tensors)."""
    if check_k(k) == 0:
        raise ValueError("pack_clustered needs k >= 1")
    if scene.num_spheres + scene.num_planes == 0:
        raise ValueError("scene has no primitives")
    tensors = _geometry(scene)
    return cached(tensors, ("cluster", k), lambda: _build(tensors, k, scene.device))
