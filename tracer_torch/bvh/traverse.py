"""BVH traversal for ray batches: a batched short stack (port of
tracer/bvh/traverse.py; reference `hit_bvh`, include/bvh.h:19-65).

The plain version of the BVH kernel (`csrc/megakernel.cu`,
`trace_kernel<..., BVH, ...>`): the reference's per-thread `int
stack[32]` becomes an `[R, D]` stack carried through one loop that runs
while any lane has a non-empty stack. D is the tree's depth, which a
near-first walk's stack never exceeds (found once per tree and cached; a
tree deeper than builder.BVH_STACK, K1-bvh's stack, is refused): the SAH
trees are deeper than a balanced tree of their size. Each pass pops a
node and slab-tests it over (T_MIN, the lane's running closest); a leaf's
primitive is accepted with `t <= closest`, so a tie goes to the primitive
visited later; an internal node pushes its far child, then its near
child, near being the left one when the ray's direction along the node's
split axis is >= 0. The slab test (geometry/aabb.py:slab_hit, bounded by each
lane's closest) propagates NaN through its min and max (a ray whose
origin lies on a box face with a zero direction component: 0 x inf), so
such a box is culled, as tracer's jnp.minimum culls it. A grazing sphere
hit whose float32 t lies before the entry of the sphere's own box is
culled once a hit nearer than that entry is known, so, like a tie, it
depends on the visit order and so on the tree; brute force takes it.

Differentiability: the traversal is discrete (which primitive wins), so
it runs on detached tensors; the winner's t and record are then
recomputed differentiably from its gathered fields (render/hit.py's
join), so autograd reaches sphere centres and radii and plane vertices.
"""

from __future__ import annotations

import torch

from tracer_torch.bvh import builder as bvh_builder
from tracer_torch.core import T_MAX, T_MIN
from tracer_torch.geometry import aabb as aabb_mod
from tracer_torch.geometry import plane as plane_mod
from tracer_torch.geometry import sphere as sphere_mod
from tracer_torch.render import hit as hit_mod
from tracer_torch.scene.types import K_INFINITY, Scene
from tracer_torch.utils.tensor_cache import cached


def stack_depth(bvh) -> int:
    """The `[R, D]` stack's D for this tree: its depth, checked against
    BVH_STACK (check_stack_capacity); cached per tree tensors."""
    def make():
        left, right = bvh.left.detach().cpu().numpy(), bvh.right.detach().cpu().numpy()
        bvh_builder.check_stack_capacity(left, right)
        return max(1, bvh_builder.tree_depth(left, right))

    return cached((bvh.left, bvh.right), ("depth",), make)


def traverse(scene: Scene, origin, direction, t_min=T_MIN, t_max=T_MAX, work=None,
             live=None, time=None):
    """Nearest-hit primitive per ray via the BVH.

    Returns (found `[R]` bool, is_sphere `[R]` bool, prim_idx `[R]` int64
    index within its kind, t `[R]`), from detached inputs. `work`, a list,
    receives the traversal's (node tests, leaves reached, primitive tests)
    as 0-d tensors, over the rays where `live` (`[R]` bool, default all):
    what the counted kernel adds up. `time` `[R]`: the rays' times, at
    which a scene's moving spheres are tested (their boxes cover the
    sweep)."""
    bvh = scene.bvh
    if bvh is None:
        raise ValueError("scene.bvh is not built (use builders.create_scene(with_bvh=True))")
    with torch.no_grad():
        origin, direction = origin.detach(), direction.detach()
        sph, pla = scene.spheres, scene.planes
        box_min, box_max = bvh.box_min.detach(), bvh.box_max.detach()
        left_all, right_all = bvh.left.long(), bvh.right.long()
        kind_all, axis_all = bvh.kind.long(), bvh.axis.long()
        depth = stack_depth(bvh)
        r, dev = origin.shape[0], origin.device
        rows = torch.arange(r, device=dev)

        stack = torch.zeros((r, depth), dtype=torch.int64, device=dev)  # root pre-pushed
        sp = torch.ones(r, dtype=torch.int64, device=dev)
        closest = torch.full((r,), t_max, dtype=torch.float32, device=dev)
        best_sphere = torch.zeros(r, dtype=torch.bool, device=dev)
        best_idx = torch.zeros(r, dtype=torch.int64, device=dev)
        found = torch.zeros(r, dtype=torch.bool, device=dev)
        counts = [torch.zeros((), dtype=torch.int64, device=dev) for _ in range(3)]

        while bool((sp > 0).any()):
            active = sp > 0
            node = stack[rows, (sp - 1).clamp_min(0)]
            node = torch.where(active, node, 0)
            sp = torch.where(active, sp - 1, sp)  # pop (bvh.h:30)

            box_ok = active & aabb_mod.slab_hit(origin, direction, box_min[node],
                                                box_max[node], t_min, closest)
            left, right, kind = left_all[node], right_all[node], kind_all[node]
            is_leaf = left < 0  # bvh.h:36
            leaf_hit = box_ok & is_leaf

            # leaf: its one primitive (bvh.h:37-49), accepted at t <= closest
            t_prim = torch.full_like(closest, K_INFINITY)
            s_ok = torch.zeros_like(found)
            p_ok = torch.zeros_like(found)
            if scene.num_spheres:
                s_sel = leaf_hit & (kind == 0)
                s_idx = torch.where(s_sel, right, 0)
                t_s = sphere_mod.sphere_t_gathered(origin, direction,
                                                   hit_mod.sphere_centers(scene, time, s_idx),
                                                   sph.radius[s_idx], t_min, K_INFINITY,
                                                   perpendicular=scene.nextweek)
                s_ok = s_sel & (t_s <= closest)
                t_prim = torch.where(s_ok, t_s, t_prim)
            if scene.num_planes:
                p_sel = leaf_hit & (kind == 1)
                p_idx = torch.where(p_sel, right, 0)
                t_p = plane_mod.plane_t_gathered(
                    origin, direction, pla.ptype[p_idx], pla.base[p_idx], pla.u[p_idx],
                    pla.v[p_idx], pla.normal[p_idx], pla.d[p_idx], pla.w[p_idx], t_min,
                    K_INFINITY)
                p_ok = p_sel & (t_p <= closest)
                t_prim = torch.where(p_ok, t_p, t_prim)
            prim_hit = s_ok | p_ok
            closest = torch.where(prim_hit, t_prim, closest)
            best_sphere = torch.where(prim_hit, s_ok, best_sphere)
            best_idx = torch.where(prim_hit, right, best_idx)
            found = found | prim_hit

            # internal: push far, then near (bvh.h:51-59)
            push = box_ok & ~is_leaf
            d_axis = direction[rows, axis_all[node]]
            left_first = d_axis >= 0.0
            for value in (torch.where(left_first, right, left),
                          torch.where(left_first, left, right)):
                at = sp.clamp_max(depth - 1)
                stack[rows, at] = torch.where(push, value, stack[rows, at])
                sp = torch.where(push, (sp + 1).clamp_max(depth), sp)
            if work is not None:
                counted = active if live is None else active & live
                counts[0] += counted.sum()
                counts[1] += (leaf_hit & counted).sum()
                counts[2] += (leaf_hit & counted).sum()
        if work is not None:
            work.append(tuple(counts))
    return found, best_sphere, best_idx, closest


def hit_scene_bvh(scene: Scene, origin, direction, t_min=T_MIN, t_max=T_MAX,
                  work=None, live=None, time=None) -> hit_mod.JoinedHit:
    """Nearest hit via the BVH, the same record as `hit_scene_brute`
    (`winner` the primitive index, spheres first). The winner's t is
    recomputed differentiably from its own fields. `work`, `live`, `time`:
    see `traverse`."""
    found, is_sphere, prim_idx, _ = traverse(scene, origin, direction, t_min, t_max, work,
                                             live, time)
    num_s, num_p = scene.num_spheres, scene.num_planes
    t_best = torch.full(found.shape, K_INFINITY, dtype=torch.float32, device=found.device)
    if num_s:
        sp = scene.spheres
        s_idx = torch.where(is_sphere, prim_idx, 0)
        t_s = sphere_mod.sphere_t_gathered(origin, direction,
                                           hit_mod.sphere_centers(scene, time, s_idx),
                                           sp.radius[s_idx], t_min, t_max,
                                           perpendicular=scene.nextweek)
        t_best = torch.where(is_sphere, t_s, t_best)
    if num_p:
        pl = scene.planes
        p_idx = torch.where(is_sphere, 0, prim_idx)
        t_p = plane_mod.plane_t_gathered(origin, direction, pl.ptype[p_idx], pl.base[p_idx],
                                         pl.u[p_idx], pl.v[p_idx], pl.normal[p_idx],
                                         pl.d[p_idx], pl.w[p_idx], t_min, t_max)
        t_best = torch.where(is_sphere, t_best, t_p)
    t_best = torch.where(found, t_best, K_INFINITY)
    winner = torch.where(found, torch.where(is_sphere, prim_idx, num_s + prim_idx), 0)
    return hit_mod._joined(scene, origin, direction, t_best, winner, time)
