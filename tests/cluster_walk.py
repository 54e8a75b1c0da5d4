"""A NumPy emulation of the cluster-culled kernel's nearest-hit walk
(`csrc/megakernel.cu`, the CLUSTERED block of `trace_pixels`), for the
tests: the same float32 slab test, skip pointers, pruning margin and
strict < in (cluster, slot) order, over a given matrix of primitive roots.
Imports numpy only (no JAX), so the CUDA tests can use it too."""

import re
from pathlib import Path

import numpy as np

MEGAKERNEL = Path(__file__).resolve().parent.parent / "tracer_torch" / "csrc" / "megakernel.cu"
T_MIN, K_INFINITY = np.float32(1e-3), np.float32(1e32)


def kernel_prune() -> np.float32:
    """The walk's pruning factor, read from the kernel's source."""
    m = re.search(r"constexpr float PRUNE = ([0-9.]+)f;", MEGAKERNEL.read_text())
    return np.float32(m.group(1))


def guarded_inv(d):
    """The kernel's guarded_inv: 1 / d with |d| held at 1e-30 or above."""
    eps = np.float32(1e-30)
    return np.float32(1) / np.where(np.abs(d) < eps, np.where(d < 0, -eps, eps), d)


def walk(nodes, slots, k, origin, direction, t_all):
    """Walk every ray through the tree as the kernel does.

    nodes: `[N, 2, 4]` float32 records (kernels/cluster.py); slots `[C*k]`
    int; origin, direction `[R, 3]` float32; t_all `[R, S+P]` float32 roots
    (K_INFINITY for none), the plain version's. Returns (t `[R]`, winner
    `[R]` (-1 for a miss), node tests `[R]`, leaves reached `[R]`, primitive
    tests `[R]`)."""
    nodes = np.asarray(nodes, np.float32)
    bits = nodes.view(np.int32)
    lo, hi = nodes[:, 0, :3], nodes[:, 1, :3]
    skip, cid = bits[:, 0, 3], bits[:, 1, 3]
    slots = np.asarray(slots).reshape(-1, k)
    o = np.asarray(origin, np.float32)
    inv = guarded_inv(np.asarray(direction, np.float32))
    t_all = np.asarray(t_all, np.float32)
    prune = kernel_prune()
    r = len(o)
    best = np.full(r, K_INFINITY, np.float32)
    winner = np.full(r, -1, np.int64)
    counts = np.zeros((3, r), np.int64)  # node tests, leaves, primitive tests
    node = np.zeros(r, np.int64)
    while True:
        live = np.nonzero(node < len(nodes))[0]
        if not len(live):
            break
        i = node[live]
        counts[0, live] += 1
        t1 = (lo[i] - o[live]) * inv[live]
        t2 = (hi[i] - o[live]) * inv[live]
        near, far = np.fmin(t1, t2), np.fmax(t1, t2)
        tmin = np.fmax(np.fmax(near[:, 0], near[:, 1]), np.fmax(near[:, 2], T_MIN))
        tmax = np.fmin(np.fmin(far[:, 0], far[:, 1]), np.fmin(far[:, 2], K_INFINITY))
        enter = (tmax > tmin) & ~(tmin > best[live] * prune)
        node[live] = np.where(enter, i + 1, skip[i])
        leaf = enter & (cid[i] >= 0)
        rays, c = live[leaf], cid[i][leaf]
        counts[1, rays] += 1
        for q in range(k):  # the slot loop, strict <
            prim = slots[c, q]
            filled = prim >= 0
            counts[2, rays[filled]] += 1
            t = np.where(filled, t_all[rays, np.where(filled, prim, 0)], K_INFINITY)
            better = t < best[rays]
            best[rays] = np.where(better, t, best[rays])
            winner[rays] = np.where(better, prim, winner[rays])
    return best, winner, counts[0], counts[1], counts[2]
