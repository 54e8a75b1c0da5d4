"""Brute nearest-hit over all primitives (port of tracer.render.hit;
reference `hit_scene`, include/scene.h:23-54).

The valid-hit parameter of every (ray, primitive) pair forms a dense
`[R, S+P]` matrix, spheres first; the argmin picks the winner, so ties go
to the lowest index with spheres before planes. The winner's record is
then recomputed from its gathered fields and joined with its material;
its index (`winner`) is what the recording renderer writes to its tape.
This one brute intersector stands in for both `hit.py` and `hit_fast.py`
of the JAX package (the latter is a TPU matrix-unit formulation).

`hit_scene_clustered` is the plain version of the cluster-culled
kernel's nearest hit (tracer/pallas/culling.py): the same matrix, masked
per ray to the primitives of the clusters whose box the ray may hit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_torch.core import T_MAX, T_MIN
from tracer_torch.geometry import aabb as aabb_mod
from tracer_torch.geometry import plane as plane_mod
from tracer_torch.geometry import sphere as sphere_mod
from tracer_torch.scene.types import K_INFINITY, Scene


class JoinedHit(NamedTuple):
    """Per-ray winner record with its material fields joined."""

    hit: torch.Tensor  # [R] bool
    t: torch.Tensor  # [R] f32
    point: torch.Tensor  # [R, 3]
    normal: torch.Tensor  # [R, 3] face-oriented
    front_face: torch.Tensor  # [R] bool
    u: torch.Tensor  # [R]
    v: torch.Tensor  # [R]
    mtype: torch.Tensor  # [R] i32
    fuzz: torch.Tensor  # [R]
    ir: torch.Tensor  # [R]
    absorption: torch.Tensor  # [R, 3]
    albedo: torch.Tensor  # [R, 3]
    emit: torch.Tensor  # [R, 3]
    tex_id: torch.Tensor  # [R] i32
    winner: torch.Tensor  # [R] i64 argmin over [spheres; planes] (meaningless on a miss)


def sphere_centers(scene: Scene, time=None, idx=None):
    """The spheres' centres (`idx`: those of spheres `idx` `[R]`, one a
    ray), each moved to its ray's `time` `[R]` where the scene has motion:
    c0 + time (c1 - c0); `[S, 3]`, `[R, S, 3]` or `[R, 3]`."""
    c = scene.spheres.center if idx is None else scene.spheres.center[idx]
    if scene.motion is None or time is None:
        return c
    if idx is None:
        return c[None] + time[:, None, None] * scene.motion[None]
    return c + time[:, None] * scene.motion[idx]


def _all_ts(scene: Scene, origin, direction, t_min, t_max, time=None):
    """The dense `[R, S+P]` valid-hit parameter matrix, spheres first."""
    num_s, num_p = scene.num_spheres, scene.num_planes
    if num_s + num_p == 0:
        raise ValueError("scene has no primitives")
    ts = []
    if num_s:
        ts.append(sphere_mod.sphere_ts(origin, direction, sphere_centers(scene, time),
                                       scene.spheres.radius, t_min, t_max,
                                       perpendicular=scene.nextweek))
    if num_p:
        ts.append(plane_mod.plane_ts(origin, direction, scene.planes, t_min, t_max))
    return torch.cat(ts, dim=1)


def _joined(scene: Scene, origin, direction, t_best, winner, time=None) -> JoinedHit:
    """The winner's record recomputed from its gathered fields, joined with
    its material; `winner` is the primitive index, spheres first; a moving
    sphere at the ray's `time`, a book 2 scene's sphere UVs the book's."""
    num_s, num_p = scene.num_spheres, scene.num_planes
    hit = t_best < K_INFINITY
    # records of missing rays are computed at a harmless t and masked later
    t_calc = torch.where(hit, t_best, 1.0)
    is_sphere = winner < num_s
    s_idx = torch.where(is_sphere, winner, 0)
    p_idx = torch.where(is_sphere, 0, winner - num_s)

    fields = []
    if num_s:
        sp = scene.spheres
        rec = sphere_mod.sphere_record(origin, direction, t_calc,
                                       sphere_centers(scene, time, s_idx), sp.radius[s_idx],
                                       book_uv=scene.nextweek)
        fields.append(rec + (sp.material_idx[s_idx],))
    if num_p:
        pl = scene.planes
        rec = plane_mod.plane_record(origin, direction, t_calc, pl.base[p_idx], pl.u[p_idx],
                                     pl.v[p_idx], pl.normal[p_idx], pl.w[p_idx])
        fields.append(rec + (pl.material_idx[p_idx],))
    if len(fields) == 2:
        sel = [is_sphere[:, None] if f.dim() == 2 else is_sphere for f in fields[0]]
        point, normal, front, u, v, midx = (
            torch.where(m, a, b) for m, a, b in zip(sel, fields[0], fields[1]))
    else:
        point, normal, front, u, v, midx = fields[0]

    mats = scene.materials
    midx = midx.long()
    return JoinedHit(
        hit=hit, t=t_best, point=point, normal=normal, front_face=front, u=u, v=v,
        mtype=mats.mtype[midx], fuzz=mats.fuzz[midx], ir=mats.ir[midx],
        absorption=mats.absorption[midx], albedo=mats.albedo[midx],
        emit=mats.emit[midx], tex_id=mats.tex_id[midx], winner=winner,
    )


def hit_scene_brute(scene: Scene, origin, direction, t_min=T_MIN, t_max=T_MAX,
                    time=None) -> JoinedHit:
    """Nearest hit over all spheres and planes; origin/direction `[R, 3]`,
    `time` `[R]` the rays' times (for a scene with motion)."""
    t_best, winner = torch.min(_all_ts(scene, origin, direction, t_min, t_max, time), dim=1)
    return _joined(scene, origin, direction, t_best, winner, time)  # first minimum: lowest index


def cluster_visibility(tables, origin, direction):
    """`[R, C]` bool: the clusters whose box each ray's slab test passes
    (tracer/pallas/culling.py:33-60: the inverse direction guarded at
    1e-30, the slab over (T_MIN, K_INFINITY))."""
    eps = 1e-30
    guarded = torch.where(direction.abs() < eps, torch.where(direction < 0, -eps, eps), direction)
    boxes = tables.boxes.T  # [C, 6]
    return aabb_mod.slab_hit(origin[:, None, :], guarded[:, None, :], boxes[None, :, :3],
                             boxes[None, :, 3:], T_MIN, K_INFINITY)


def hit_scene_clustered(scene: Scene, tables, origin, direction, t_min=T_MIN, t_max=T_MAX):
    """Nearest hit over the primitives of the clusters (`tables`, a
    kernels.cluster.ClusterTables of this scene) whose box the ray's own
    slab test passes. Same record as `hit_scene_brute`, `winner` the
    original primitive index; ties go to the lowest (cluster, slot), the
    order in which tracer's legacy clustered intersector visits them. A
    ray's answer differs from the brute one only where its slab test
    rejects the box of the primitive it hits, by rounding at a box face."""
    t_all = _all_ts(scene, origin, direction, t_min, t_max)
    n = t_all.shape[1]
    slots = tables.slots.long()
    filled = slots >= 0
    t_pad = torch.cat([t_all, t_all.new_full((t_all.shape[0], 1), K_INFINITY)], dim=1)
    t_slot = t_pad[:, torch.where(filled, slots, n)]  # [R, C*K] in slot order
    vis = cluster_visibility(tables, origin, direction)  # [R, C]
    t_vis = torch.where(vis.repeat_interleave(tables.k, dim=1), t_slot, K_INFINITY)
    t_best, j = torch.min(t_vis, dim=1)  # first minimum: lowest (cluster, slot)
    return _joined(scene, origin, direction, t_best, torch.where(filled, slots, 0)[j])
