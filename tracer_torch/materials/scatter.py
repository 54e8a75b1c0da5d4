"""Branchless material scatter with the fixed 8-draw budget (port of
tracer.materials.scatter.scatter): the 4-way switch of reference
`material_scatter` (include/materials.h:70-140) as masked selects.

Per-bounce draws, in stream order (the CUDA kernel draws the same):
  u_choice  (1)  - METAL specular-vs-diffuse gate   (materials.h:83)
  hemi      (2)  - hemisphere direction             (materials.h:74, :89)
  ball      (3)  - in-unit-sphere fuzz offset       (materials.h:86)
  u_refl    (1)  - DIELECTRIC reflectance gate      (materials.h:109)
  u_rr      (1)  - DIELECTRIC Russian roulette      (materials.h:124)
"""

from __future__ import annotations

import torch

from tracer_torch.core import rng, vec
from tracer_torch.scene.types import DIELECTRIC, LAMBERTIAN, METAL

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


def scatter(ray_origin, ray_dir, point, normal, front_face, mtype, fuzz, ir,
            absorption, albedo, seed):
    """One scatter event for a batch of rays; every argument is per ray
    (`[R, 3]` or `[R]`, `albedo` already texture-modulated, `seed` int64
    holding uint32). Returns (seed, new_origin, new_dir, attenuation, ok);
    `ok` False kills the path (light, metal below the horizon, dielectric
    roulette) like the reference's bool return."""
    seed, u_choice = rng.random_float(seed)
    seed, hemi = rng.random_in_hemisphere(normal, seed)
    seed, ball = rng.random_in_unit_sphere(seed)
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

    # DIELECTRIC (materials.h:97-133)
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
    die_ok = u_rr <= p_rr
    die_att = die_att / torch.clamp_min(p_rr, 1e-30)[..., None]
    side = torch.where(vec.dot(die_dir, normal) > 0.0, 1.0, -1.0)
    die_origin = point + normal * (DIELECTRIC_OFFSET * side)[..., None]

    is_lam = mtype == LAMBERTIAN
    is_metal = mtype == METAL
    is_die = mtype == DIELECTRIC
    new_dir = torch.where(
        is_lam[..., None], lam_dir, torch.where(is_metal[..., None], metal_dir, die_dir)
    )
    new_origin = torch.where(is_die[..., None], die_origin, point)
    attenuation = torch.where(is_die[..., None], die_att, albedo)
    # DIFFUSE_LIGHT (materials.h:135-137) falls through to False
    ok = is_lam | (is_metal & metal_ok) | (is_die & die_ok)
    return seed, new_origin, new_dir, attenuation, ok
