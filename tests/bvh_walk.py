"""A NumPy emulation of the BVH kernel's nearest-hit walk (`csrc/megakernel.cu`,
the BVH block of `trace_pixel`) and of the plain stack walk it replaced
(`tracer_torch/bvh/traverse.py`), for the tests: the same float32 slab test
(unguarded 1/d, NaN cull), the same t <= best at the leaves, over a given
matrix of primitive roots. `walk` reads the child-pair records of
`kernels/pack.py:pack_bvh`; `plain_walk` the BVH's node arrays. Both return
each ray's leaves in the order they were tested, so a test can hold the
two visit orders against each other. Imports numpy only (no JAX), so the
CUDA tests can use it too."""

import numpy as np

T_MIN, T_MAX = np.float32(1e-3), np.float32(1e30)
NONE = -1  # the kernel's BVH_NONE: no node pending


def _box(lo, hi, o, iv, best):
    """The kernel's bvh_box over rows: (passes, entry distance tmin)."""
    t1 = (lo - o) * iv
    t2 = (hi - o) * iv
    nan6 = np.isnan(t1).any(axis=1) | np.isnan(t2).any(axis=1)
    near, far = np.fmin(t1, t2), np.fmax(t1, t2)
    tmin = np.fmax(np.fmax(near[:, 0], near[:, 1]), np.fmax(near[:, 2], T_MIN))
    tmax = np.fmin(np.fmin(far[:, 0], far[:, 1]), np.fmin(far[:, 2], best))
    return ~nan6 & (tmax > tmin), tmin


class _Rays:
    """Per-ray state shared by both walks: best, winner, counts, leaf order."""

    def __init__(self, origin, direction, t_all):
        self.o = np.asarray(origin, np.float32)
        self.d = np.asarray(direction, np.float32)
        with np.errstate(divide="ignore"):
            self.iv = np.float32(1) / self.d
        self.t_all = np.asarray(t_all, np.float32)
        r = len(self.o)
        self.best = np.full(r, T_MAX, np.float32)
        self.winner = np.full(r, -1, np.int64)
        self.node_tests = np.zeros(r, np.int64)
        self.leaves = np.zeros(r, np.int64)
        self.order = [[] for _ in range(r)]

    def box(self, rays, lo, hi):
        with np.errstate(invalid="ignore"):
            return _box(lo, hi, self.o[rays], self.iv[rays], self.best[rays])

    def test_leaves(self, rays, prim):
        """The leaves' one primitive each, accepted at t <= best."""
        t = self.t_all[rays, prim]
        take = t <= self.best[rays]
        self.best[rays] = np.where(take, t, self.best[rays])
        self.winner[rays] = np.where(take, prim, self.winner[rays])
        self.leaves[rays] += 1
        for ray, p in zip(rays.tolist(), prim.tolist()):
            self.order[ray].append(p)

    def result(self):
        return self.best, self.winner, self.node_tests, self.leaves, self.order


def walk(records, origin, direction, t_all):
    """The kernel's child-pair walk for every ray.

    records: `[I + 1, 4, 4]` float32 (pack_bvh); origin, direction `[R, 3]`
    float32; t_all `[R, S+P]` float32 roots (K_INFINITY, or anything above
    T_MAX, for none), spheres first. Returns (t `[R]` (T_MAX for a miss),
    winner `[R]` (-1 for a miss), node tests `[R]`, leaves `[R]`, each ray's
    tested primitives in order)."""
    rec = np.asarray(records, np.float32).reshape(-1, 4, 4)
    bits = rec.view(np.int32)
    lo, hi = rec[:, 0::2, :3], rec[:, 1::2, :3]  # [I + 1, child, 3]
    axis, ident = bits[:, 0::2, 3], bits[:, 1::2, 3]
    code = np.where(axis < 0, -2 - ident, ident * 4 + axis)  # the kernel's bvh_child
    s = _Rays(origin, direction, t_all)
    r = len(s.o)
    depth = 64
    stack_n = np.zeros((r, depth), np.int64)
    stack_t = np.zeros((r, depth), np.float32)
    sp = np.zeros(r, np.int64)
    every = np.arange(r)
    ok, _ = s.box(every, lo[0, 0], hi[0, 0])  # the root, from record 0
    s.node_tests += 1
    nxt = np.where(ok, code[0, 0], NONE)
    while True:
        # each ray takes one step of its own walk; the rays are independent
        leaf = np.nonzero(nxt <= -2)[0]
        pop = np.nonzero((nxt == NONE) & (sp > 0))[0]
        visit = np.nonzero(nxt >= 0)[0]
        if not (len(leaf) or len(pop) or len(visit)):
            break
        if len(leaf):
            s.test_leaves(leaf, -2 - nxt[leaf])
            nxt[leaf] = NONE
        if len(pop):  # skip an entry that now starts at or past best
            sp[pop] -= 1
            e, t = stack_n[pop, sp[pop]], stack_t[pop, sp[pop]]
            nxt[pop] = np.where(s.best[pop] > t, e, NONE)
        if len(visit):
            c = nxt[visit]
            rec_i, ax = c >> 2, c & 3
            s.node_tests[visit] += 2
            l_ok, l_t = s.box(visit, lo[rec_i, 0], hi[rec_i, 0])
            r_ok, r_t = s.box(visit, lo[rec_i, 1], hi[rec_i, 1])
            left_first = s.d[visit, ax] >= 0
            near_ok = np.where(left_first, l_ok, r_ok)
            far_ok = np.where(left_first, r_ok, l_ok)
            near = np.where(left_first, code[rec_i, 0], code[rec_i, 1])
            far = np.where(left_first, code[rec_i, 1], code[rec_i, 0])
            push = near_ok & far_ok
            pr = visit[push]
            stack_n[pr, sp[pr]] = far[push]
            stack_t[pr, sp[pr]] = np.where(left_first, r_t, l_t)[push]
            sp[pr] += 1
            assert sp.max() < depth
            nxt[visit] = np.where(near_ok, near, np.where(far_ok, far, NONE))
    return s.result()


def plain_walk(box_min, box_max, left, right, kind, axis, num_s, origin, direction, t_all):
    """The plain traversal's stack walk (traverse.py) for every ray, over
    the BVH's node arrays: pop, slab-test over (T_MIN, best), at a leaf test
    its primitive, else push far, then near. Arguments after the arrays and
    the return value as `walk`'s."""
    box_min, box_max = np.asarray(box_min, np.float32), np.asarray(box_max, np.float32)
    left, right = np.asarray(left, np.int64), np.asarray(right, np.int64)
    kind, axis = np.asarray(kind), np.asarray(axis, np.int64)
    prim_of = np.where(kind == 0, right, num_s + right)
    s = _Rays(origin, direction, t_all)
    r = len(s.o)
    depth = 64
    stack = np.zeros((r, depth), np.int64)  # the root pre-pushed
    sp = np.ones(r, np.int64)
    while True:
        rays = np.nonzero(sp > 0)[0]
        if not len(rays):
            break
        sp[rays] -= 1
        node = stack[rays, sp[rays]]
        s.node_tests[rays] += 1
        ok, _ = s.box(rays, box_min[node], box_max[node])
        is_leaf = left[node] < 0
        at_leaf = ok & is_leaf
        if at_leaf.any():
            s.test_leaves(rays[at_leaf], prim_of[node[at_leaf]])
        inner = ok & ~is_leaf
        ir, node = rays[inner], node[inner]
        left_first = s.d[ir, axis[node]] >= 0
        for child in (np.where(left_first, right[node], left[node]),
                      np.where(left_first, left[node], right[node])):
            stack[ir, sp[ir]] = child
            sp[ir] += 1
        assert sp.max() < depth
    return s.result()
