"""Path-trace integrator (port of tracer.render.integrator, fixed RNG
stream, brute intersection): the reference's per-thread bounce loop
(src/camera.cu:218-288) over a batch of rays with an `alive` mask.

The loop stops as soon as every ray of the batch has terminated (the
JAX package's `early_exit`), which changes no value: dead rays keep
their state.
"""

from __future__ import annotations

import torch

from tracer_torch.core import rng as rng_mod
from tracer_torch.materials import scatter as scatter_mod
from tracer_torch.materials import texture as texture_mod
from tracer_torch.render import hit as hit_mod
from tracer_torch.scene.types import Scene

RR_MIN_P = 0.05  # Russian-roulette survival floor (== the kernel's RR_MIN_P)


def _bounce(scene: Scene, background, carry, rr_start=None, depth=0):
    origin, direction, beta, final, seed, alive = carry
    rec = hit_mod.hit_scene_brute(scene, origin, direction)

    # miss: final += beta * background, the path dies (camera.cu:226-229)
    miss = alive & ~rec.hit
    final = final + torch.where(miss[..., None], beta * background, 0.0)
    active = alive & rec.hit

    # texture-modulated albedo (camera.cu:233-236)
    albedo = rec.albedo
    if scene.textures is not None:
        tex_rgb = texture_mod.sample_bilinear(scene.textures, rec.tex_id, rec.u, rec.v)
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
        p = torch.clamp(torch.amax(beta, dim=-1), RR_MIN_P, 1.0)
        do = live & (depth >= rr_start)
        kill = do & (u_t >= p)
        scale = torch.where(do & ~kill, 1.0 / p, 1.0)
        beta = beta * scale[..., None]
        live = live & ~kill
    return origin, direction, beta, final, seed, live


def trace(scene: Scene, background, origin, direction, seed, max_depth: int, rr_start=None):
    """Radiance `[R, 3]` for a batch of rays; `seed` is `[R]` int64 holding
    uint32, already advanced past ray generation. Returns (final, seed)."""
    beta = torch.ones_like(origin)
    final = torch.zeros_like(origin)
    alive = torch.ones(origin.shape[0], dtype=torch.bool, device=origin.device)
    carry = (origin, direction, beta, final, seed, alive)
    for depth in range(max_depth):
        carry = _bounce(scene, background, carry, rr_start=rr_start, depth=depth)
        if not bool(carry[-1].any()):
            break
    _, _, _, final, seed, _ = carry
    return final, seed
