"""Path-trace integrator (port of tracer.render.integrator, fixed RNG
stream, brute or cluster-culled intersection): the reference's per-thread bounce loop
(src/camera.cu:218-288) over a batch of rays with an `alive` mask.

The loop stops as soon as every ray of the batch has terminated (the
JAX package's `early_exit`), which changes no value: dead rays keep
their state.

With `tape_fields` set, `trace` also returns what the recording kernel
(tracer/pallas/kernels.py:_kernel, `record_idx=True`) writes per bounce:
the winner index of every ray alive at that bounce (-1 for a miss) and,
in a textured scene, the texture tape fields (multipliers, d(texel)/du,
d(texel)/dv and, with 13 fields, the bilinear addressing).
"""

from __future__ import annotations

import torch

from tracer_torch.core import rng as rng_mod
from tracer_torch.materials import scatter as scatter_mod
from tracer_torch.materials import texture as texture_mod
from tracer_torch.render import hit as hit_mod
from tracer_torch.scene.types import Scene

RR_MIN_P = 0.05  # Russian-roulette survival floor (== the kernel's RR_MIN_P)
TAPE_FIELDS = (9, 13)  # texture tape widths the recording path writes
# a tape slot's value where nothing textured was hit: multipliers 1, the rest 0
TAPE_NEUTRAL = (1.0,) * 3 + (0.0,) * 10


def roulette_p(beta):
    """Survival probability clip(max(beta), RR_MIN_P, 1), written as the
    JAX kernels write it (nested maximum, clip as minimum of maximum) so
    that its gradient splits ties as theirs does."""
    m = scatter_mod.max3(beta)
    return torch.minimum(torch.maximum(m, m.new_tensor(RR_MIN_P)), m.new_tensor(1.0))


def _bounce(scene: Scene, background, carry, rr_start=None, depth=0, tape_fields=None,
            clusters=None):
    origin, direction, beta, final, seed, alive = carry
    if clusters is None:
        rec = hit_mod.hit_scene_brute(scene, origin, direction)
    else:
        rec = hit_mod.hit_scene_clustered(scene, clusters, origin, direction)

    # miss: final += beta * background, the path dies (camera.cu:226-229)
    miss = alive & ~rec.hit
    final = final + torch.where(miss[..., None], beta * background, 0.0)
    active = alive & rec.hit

    # texture-modulated albedo (camera.cu:233-236)
    albedo = rec.albedo
    tex_slot = None
    if scene.textures is not None:
        if tape_fields is None:
            tex_rgb = texture_mod.sample_bilinear(scene.textures, rec.tex_id, rec.u, rec.v)
        else:
            tex_rgb, d_u, d_v, addr = texture_mod.bilinear_tape(scene.textures, rec.tex_id,
                                                                rec.u, rec.v)
            vals = torch.cat([tex_rgb, d_u, d_v, addr], dim=-1)[:, :tape_fields]
            neutral = vals.new_tensor(TAPE_NEUTRAL[:tape_fields])
            took = active & (rec.tex_id >= 0)
            tex_slot = torch.where(took[..., None], vals, neutral)
        albedo = torch.where((rec.tex_id >= 0)[..., None], albedo * tex_rgb, albedo)

    # emission before scatter (camera.cu:237-238)
    final = final + torch.where(active[..., None], beta * rec.emit, 0.0)

    seed, new_origin, new_dir, attenuation, ok = scatter_mod.scatter(
        origin, direction, rec.point, rec.normal, rec.front_face,
        rec.mtype, rec.fuzz, rec.ir, rec.absorption, albedo, seed,
    )
    live = active & ok
    beta = torch.where(live[..., None], beta * attenuation, beta)
    origin = torch.where(live[..., None], new_origin, origin)
    direction = torch.where(live[..., None], new_dir, direction)

    if rr_start is not None:
        # throughput Russian roulette from bounce `rr_start` on: one extra
        # draw after the scatter budget, kill with probability 1 - max(beta)
        seed, u_t = rng_mod.random_float(seed)
        p = roulette_p(beta)
        do = live & (depth >= rr_start)
        kill = do & (u_t >= p)
        scale = torch.where(do & ~kill, 1.0 / p, 1.0)
        beta = beta * scale[..., None]
        live = live & ~kill
    carry = origin, direction, beta, final, seed, live
    if tape_fields is None:
        return carry
    return carry, (torch.where(active, rec.winner, -1).to(torch.int32), tex_slot)


def trace(scene: Scene, background, origin, direction, seed, max_depth: int, rr_start=None,
          tape_fields=None, clusters=None, queries=None):
    """Radiance `[R, 3]` for a batch of rays; `seed` is `[R]` int64 holding
    uint32, already advanced past ray generation. `clusters` (the scene's
    kernels.cluster.ClusterTables, or None for brute force) selects the
    cluster-culled nearest hit. Returns (final, seed), or
    with `tape_fields` (9 or 13; ignored for an untextured scene) (final,
    seed, slots): one (winner `[R]` int32, texture fields `[R, F]` or None)
    per bounce executed. `queries`, a list, receives per bounce executed the
    count (a 0-d tensor) of rays alive at its start: its nearest-hit
    queries."""
    beta = torch.ones_like(origin)
    final = torch.zeros_like(origin)
    alive = torch.ones(origin.shape[0], dtype=torch.bool, device=origin.device)
    carry = (origin, direction, beta, final, seed, alive)
    slots = []
    for depth in range(max_depth):
        if queries is not None:
            queries.append(carry[-1].sum())
        if tape_fields is None:
            carry = _bounce(scene, background, carry, rr_start=rr_start, depth=depth,
                            clusters=clusters)
        else:
            carry, slot = _bounce(scene, background, carry, rr_start=rr_start, depth=depth,
                                  tape_fields=tape_fields, clusters=clusters)
            slots.append(slot)
        if not bool(carry[-1].any()):
            break
    _, _, _, final, seed, _ = carry
    if tape_fields is None:
        return final, seed
    return final, seed, slots
