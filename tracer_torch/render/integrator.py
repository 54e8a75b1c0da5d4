"""Path-trace integrator (port of tracer.render.integrator; brute, BVH or
cluster-culled intersection; the fixed or the reference RNG stream): the reference's
per-thread bounce loop (src/camera.cu:218-288) over a batch of rays with
an `alive` mask.

Intersectors (`INTERSECTORS`): "brute" tests every primitive
(render/hit.py); "fast" is its alias, since the port's one brute
intersector stands for both of tracer's (hit.py and hit_fast.py);
"bvh" traverses `scene.bvh` (tracer_torch.bvh.traverse).

`rng_mode` (`RNG_MODES`): "fixed", the 8-draw budget per bounce that the
kernels share, or "reference", the reference binary's own per-lane
stream (materials/scatter.py:scatter_reference).

The loop stops as soon as every ray of the batch has terminated (the
JAX package's `early_exit`), which changes no value: dead rays keep
their state.

With `tape_fields` set, `trace` also returns what the recording kernel
(tracer/pallas/kernels.py:_kernel, `record_idx=True`) writes per bounce:
the winner index of every ray alive at that bounce (-1 for a miss) and,
in a textured scene, the texture tape fields (multipliers; with 9 or 13
fields d(texel)/du and d(texel)/dv; with 13 the bilinear addressing; with
0 none, the winner index alone).
"""

from __future__ import annotations

import torch

from tracer_torch.bvh import traverse as bvh_traverse
from tracer_torch.core import rng as rng_mod
from tracer_torch.core import vec
from tracer_torch.materials import scatter as scatter_mod
from tracer_torch.materials import texture as texture_mod
from tracer_torch.render import hit as hit_mod
from tracer_torch.scene.types import Scene

RR_MIN_P = 0.05  # Russian-roulette survival floor (== the kernel's RR_MIN_P)
INTERSECTORS = ("fast", "brute", "bvh")
RNG_MODES = ("fixed", "reference")
TAPE_FIELDS = (0, 3, 9, 13)  # texture tape widths the recording path writes
# a tape slot's value where nothing textured was hit: multipliers 1, the rest 0
TAPE_NEUTRAL = (1.0,) * 3 + (0.0,) * 10


def roulette_p(beta):
    """Survival probability clip(max(beta), RR_MIN_P, 1), written as the
    JAX kernels write it (nested maximum, clip as minimum of maximum) so
    that its gradient splits ties as theirs does."""
    m = scatter_mod.max3(beta)
    return torch.minimum(torch.maximum(m, m.new_tensor(RR_MIN_P)), m.new_tensor(1.0))


def check_intersector(intersector: str, scene: Scene = None) -> str:
    """`intersector` if it is one of INTERSECTORS (and, for "bvh", the
    scene has its BVH), else ValueError."""
    if intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {intersector!r}; expected one of {INTERSECTORS}")
    if intersector == "bvh" and scene is not None and scene.bvh is None:
        raise ValueError("intersector 'bvh' needs scene.bvh "
                         "(builders.create_scene(with_bvh=True))")
    return intersector


def check_rng_mode(rng_mode: str, rr_start=None) -> str:
    """`rng_mode` if it is one of RNG_MODES, else ValueError; "reference"
    with `rr_start` also raises (tracer/render/integrator.py:195: the
    throughput roulette's extra draw belongs to the fixed stream)."""
    if rng_mode not in RNG_MODES:
        raise ValueError(f"unknown rng_mode {rng_mode!r}; expected one of {RNG_MODES}")
    if rng_mode == "reference" and rr_start is not None:
        raise ValueError("rr_start requires the fixed-budget RNG stream")
    return rng_mode


def sky_radiance(sky, direction):
    """The sky's radiance `[R, 3]` along `direction` `[R, 3]` (not normalised):
    (1 - t) bottom + t top, t = 0.5 (unit(d).z + 1), in the CUDA kernel's
    float forms."""
    a = vec.length_squared(direction)
    uz = direction[..., 2] * (1.0 / torch.sqrt(torch.clamp_min(a, 1e-30)))
    t = (0.5 * (uz + 1.0))[..., None]
    return sky.bottom * (1.0 - t) + sky.top * t


def _bounce(scene: Scene, background, carry, rr_start=None, depth=0, tape_fields=None,
            clusters=None, intersector="brute", work=None, rng_mode="fixed"):
    origin, direction, beta, final, seed, alive = carry
    if clusters is not None:
        rec = hit_mod.hit_scene_clustered(scene, clusters, origin, direction)
    elif intersector == "bvh":
        rec = bvh_traverse.hit_scene_bvh(scene, origin, direction, work=work, live=alive)
    else:
        rec = hit_mod.hit_scene_brute(scene, origin, direction)

    # miss: final += beta * background (or the scene's sky), the path dies
    # (camera.cu:226-229)
    miss = alive & ~rec.hit
    if scene.sky is not None:
        background = sky_radiance(scene.sky, direction)
    final = final + torch.where(miss[..., None], beta * background, 0.0)
    active = alive & rec.hit

    # texture-modulated albedo (camera.cu:233-236)
    albedo = rec.albedo
    tex_slot = None
    if scene.textures is not None:
        if not tape_fields:
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

    scatter_fn = scatter_mod.scatter_reference if rng_mode == "reference" else scatter_mod.scatter
    seed, new_origin, new_dir, attenuation, ok = scatter_fn(
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
          tape_fields=None, clusters=None, queries=None, intersector: str = "brute",
          work=None, rng_mode: str = "fixed"):
    """Radiance `[R, 3]` for a batch of rays; `seed` is `[R]` int64 holding
    uint32, already advanced past ray generation. `clusters` (the scene's
    kernels.cluster.ClusterTables, or None) selects the cluster-culled
    nearest hit; else `intersector` (INTERSECTORS) picks brute force or
    the BVH, whose traversal adds the work of the rays alive at a bounce
    to `work`, a list, per bounce (see bvh.traverse.traverse). Returns (final, seed), or
    with `tape_fields` (0, 3, 9 or 13; ignored for an untextured scene)
    (final, seed, slots): one (winner `[R]` int32, texture fields `[R, F]`,
    or None with no texture or no fields)
    per bounce executed. `queries`, a list, receives per bounce executed the
    count (a 0-d tensor) of rays alive at its start: its nearest-hit
    queries. `rng_mode`: "fixed" or "reference" (RNG_MODES); "reference"
    refuses `rr_start` and `tape_fields`, as tracer's recording path has no
    reference stream. A scene's `sky` replaces `background` on a miss."""
    check_intersector(intersector, scene)
    check_rng_mode(rng_mode, rr_start)
    if rng_mode == "reference" and tape_fields is not None:
        raise ValueError("the recording path runs the fixed-budget RNG stream only")
    beta = torch.ones_like(origin)
    final = torch.zeros_like(origin)
    alive = torch.ones(origin.shape[0], dtype=torch.bool, device=origin.device)
    carry = (origin, direction, beta, final, seed, alive)
    slots = []
    for depth in range(max_depth):
        if queries is not None:
            queries.append(carry[-1].sum())
        kw = dict(rr_start=rr_start, depth=depth, clusters=clusters, intersector=intersector,
                  work=work, rng_mode=rng_mode)
        if tape_fields is None:
            carry = _bounce(scene, background, carry, **kw)
        else:
            carry, slot = _bounce(scene, background, carry, tape_fields=tape_fields, **kw)
            slots.append(slot)
        if not bool(carry[-1].any()):
            break
    _, _, _, final, seed, _ = carry
    if tape_fields is None:
        return final, seed
    return final, seed, slots
