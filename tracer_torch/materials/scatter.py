"""Branchless material scatter (port of tracer.materials.scatter): the
4-way switch of reference `material_scatter` (include/materials.h:70-140)
as masked selects, on two RNG streams.

`scatter`, the fixed 8-draw budget (`rng_mode="fixed"`); per-bounce
draws, in stream order (the CUDA kernel draws the same):
  u_choice  (1)  - METAL specular-vs-diffuse gate   (materials.h:83)
  hemi      (2)  - hemisphere direction             (materials.h:74, :89)
  ball      (3)  - in-unit-sphere fuzz offset       (materials.h:86); its
                   direction is RTIOW_LAMBERTIAN's unit vector
  u_refl    (1)  - DIELECTRIC reflectance gate      (materials.h:109)
  u_rr      (1)  - DIELECTRIC Russian roulette      (materials.h:124)
The RTIOW book's two materials (scene/types.py: RTIOW_LAMBERTIAN,
RTIOW_METAL) take their draws from the same slots.

`scatter_reference`, the reference binary's own stream (`rng_mode=
"reference"`): rejection samplers and conditional draws, per material.
"""

from __future__ import annotations

import torch

from tracer_torch.core import rng, vec
from tracer_torch.scene.types import DIELECTRIC, LAMBERTIAN, METAL, RTIOW_LAMBERTIAN, RTIOW_METAL

METAL_SPECULAR_P = 0.8  # materials.h:82 (p_metal)
DIELECTRIC_OFFSET = 1e-4  # materials.h:127


def max3(x: torch.Tensor) -> torch.Tensor:
    """max(x0, max(x1, x2)) over the trailing axis: the same value as amax,
    with the gradient of the JAX kernels at ties (half to each side of a
    tied maximum, where amax shares it evenly over all ties)."""
    return torch.maximum(x[..., 0], torch.maximum(x[..., 1], x[..., 2]))


def reflectance(cosine, ref_idx):
    """Schlick approximation (reference materials.h:64-68)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def _dielectric(ray_origin, unit_dir, point, normal, front_face, ir, absorption, u_refl):
    """DIELECTRIC (materials.h:97-133) given its reflectance uniform:
    (direction, origin, attenuation over the roulette's p, that p,
    cannot_refract). The caller draws the roulette's uniform and keeps the
    path where it is <= p (materials.h:123-125)."""
    ratio = torch.where(front_face, 1.0 / ir, ir)
    cos_theta = torch.clamp_max(vec.dot(-unit_dir, normal), 1.0)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ratio * sin_theta > 1.0
    choose_reflect = cannot_refract | (reflectance(cos_theta, ratio) > u_refl)
    die_dir = torch.where(
        choose_reflect[..., None],
        vec.reflect(unit_dir, normal),
        vec.refract(unit_dir, normal, ratio),
    )
    # Beer-Lambert absorption on back-face exit (materials.h:114-121)
    distance = vec.length(point - ray_origin)
    transmission = torch.exp(-absorption * distance[..., None])
    die_att = torch.where(front_face[..., None], 1.0, transmission)
    # Russian roulette on the max channel (materials.h:123-125); nested
    # maximum, whose gradient splits ties as the backward kernel's does
    p_rr = max3(die_att)
    die_att = die_att / torch.clamp_min(p_rr, 1e-30)[..., None]
    side = torch.where(vec.dot(die_dir, normal) > 0.0, 1.0, -1.0)
    die_origin = point + normal * (DIELECTRIC_OFFSET * side)[..., None]
    return die_dir, die_origin, die_att, p_rr, cannot_refract


def _select(mtype, point, albedo, lam_dir, metal_dir, metal_ok, die_dir, die_origin, die_att,
            die_ok):
    """The 4-way material switch as selects: (new_origin, new_dir,
    attenuation, ok); DIFFUSE_LIGHT (materials.h:135-137) gives ok False."""
    is_lam = mtype == LAMBERTIAN
    is_metal = mtype == METAL
    is_die = mtype == DIELECTRIC
    new_dir = torch.where(
        is_lam[..., None], lam_dir, torch.where(is_metal[..., None], metal_dir, die_dir)
    )
    new_origin = torch.where(is_die[..., None], die_origin, point)
    attenuation = torch.where(is_die[..., None], die_att, albedo)
    ok = is_lam | (is_metal & metal_ok) | (is_die & die_ok)
    return new_origin, new_dir, attenuation, ok


def scatter(ray_origin, ray_dir, point, normal, front_face, mtype, fuzz, ir,
            absorption, albedo, seed):
    """One scatter event for a batch of rays; every argument is per ray
    (`[R, 3]` or `[R]`, `albedo` already texture-modulated, `seed` int64
    holding uint32). Returns (seed, new_origin, new_dir, attenuation, ok);
    `ok` False kills the path (light, metal below the horizon, dielectric
    roulette) like the reference's bool return."""
    seed, u_choice = rng.random_float(seed)
    seed, hemi = rng.random_in_hemisphere(normal, seed)
    seed, ball, ball_dir = rng.random_ball(seed)
    seed, u_refl = rng.random_float(seed)
    seed, u_rr = rng.random_float(seed)

    unit_dir = vec.unit_vector(ray_dir, eps=1e-30)

    # LAMBERTIAN (materials.h:73-79): degenerate direction -> normal
    lam_dir = torch.where(vec.near_zero(hemi)[..., None], normal, hemi)

    # METAL (materials.h:81-95): 0.8 specular reflect + fuzz, else diffuse
    spec = u_choice < METAL_SPECULAR_P
    refl_dir = vec.reflect(unit_dir, normal) + fuzz[..., None] * ball
    metal_dir = torch.where(spec[..., None], refl_dir, lam_dir)
    metal_ok = torch.where(spec, vec.dot(refl_dir, normal) > 0.0, True)

    die_dir, die_origin, die_att, p_rr, _ = _dielectric(ray_origin, unit_dir, point, normal,
                                                        front_face, ir, absorption, u_refl)
    # DIFFUSE_LIGHT (materials.h:135-137) falls through to False
    new_origin, new_dir, attenuation, ok = _select(mtype, point, albedo, lam_dir, metal_dir,
                                                   metal_ok, die_dir, die_origin, die_att,
                                                   u_rr <= p_rr)
    # RTIOW_LAMBERTIAN: n + unit vector, the normal where that is near zero;
    # RTIOW_METAL: the specular branch without its gate (the attenuation is
    # the albedo and the origin the point, as _select gives every code but
    # the dielectric)
    rl_dir = normal + ball_dir
    rl_dir = torch.where(vec.near_zero(rl_dir)[..., None], normal, rl_dir)
    is_rl, is_rm = mtype == RTIOW_LAMBERTIAN, mtype == RTIOW_METAL
    new_dir = torch.where(is_rl[..., None], rl_dir,
                          torch.where(is_rm[..., None], refl_dir, new_dir))
    ok = ok | is_rl | (is_rm & (vec.dot(refl_dir, normal) > 0.0))
    return seed, new_origin, new_dir, attenuation, ok


def scatter_reference(ray_origin, ray_dir, point, normal, front_face, mtype, fuzz, ir,
                      absorption, albedo, seed):
    """`scatter`'s contract on the reference-stream RNG: each lane's seed
    advances exactly as the reference binary's (materials.h:70-140), with
    the rejection-loop samplers (random_utils.h:25-42) and conditional
    draws:

      LAMBERTIAN      hemisphere rejection draws only
      METAL           1 gate draw, then ball rejection (specular) or
                      hemisphere rejection (diffuse)
      DIELECTRIC      the reflectance draw only when refraction is possible
                      (the || short circuit at materials.h:109), then the
                      Russian-roulette draw
      DIFFUSE_LIGHT   no draws

    Every branch runs for every lane, each threading its own seed chain
    from the same input seed; the lane's material selects its chain's
    seed. The CUDA kernel (K1-ref) runs only the lane's own branch."""
    unit_dir = vec.unit_vector(ray_dir, eps=1e-30)

    # LAMBERTIAN (materials.h:73-79)
    seed_lam, hemi_lam = rng.random_in_hemisphere_ref(normal, seed)
    lam_dir = torch.where(vec.near_zero(hemi_lam)[..., None], normal, hemi_lam)

    # METAL (materials.h:81-95)
    seed_gate, u_choice = rng.random_float(seed)
    spec = u_choice < METAL_SPECULAR_P
    seed_ball, ball = rng.random_in_unit_sphere_rejection(seed_gate)
    seed_mhemi, hemi_m = rng.random_in_hemisphere_ref(normal, seed_gate)
    refl_dir = vec.reflect(unit_dir, normal) + fuzz[..., None] * ball
    met_diff = torch.where(vec.near_zero(hemi_m)[..., None], normal, hemi_m)
    metal_dir = torch.where(spec[..., None], refl_dir, met_diff)
    metal_ok = torch.where(spec, vec.dot(refl_dir, normal) > 0.0, True)
    seed_metal = torch.where(spec, seed_ball, seed_mhemi)

    # DIELECTRIC (materials.h:97-133): the reflectance draw only when
    # refraction is possible (the || short circuit at materials.h:109),
    # then the roulette's
    seed_refl, u_refl = rng.random_float(seed)
    die_dir, die_origin, die_att, p_rr, cannot_refract = _dielectric(
        ray_origin, unit_dir, point, normal, front_face, ir, absorption, u_refl)
    seed_die, u_rr = rng.random_float(torch.where(cannot_refract, seed, seed_refl))

    new_origin, new_dir, attenuation, ok = _select(mtype, point, albedo, lam_dir, metal_dir,
                                                   metal_ok, die_dir, die_origin, die_att,
                                                   u_rr <= p_rr)
    # DIFFUSE_LIGHT keeps its seed: no draws
    new_seed = torch.where(mtype == LAMBERTIAN, seed_lam,
                           torch.where(mtype == METAL, seed_metal,
                                       torch.where(mtype == DIELECTRIC, seed_die, seed)))
    return new_seed, new_origin, new_dir, attenuation, ok
