"""Stateless counter-based wang_hash streams (port of tracer.core.rng,
fixed-budget half).

torch has few uint32 operations, so a seed here is an int64 tensor that
holds a uint32 value: every step masks with `& 0xFFFFFFFF`. The largest
product, (2^32 - 1) * 0x27D4EB2D, is below 2^63, so nothing overflows and
the streams are bit-exact against the JAX package and the CUDA kernel.

`random_float` converts the 32-bit value to float32 in one rounding
(int64 -> float32), as the XLA path's uint32 -> float32 cast does; values
near 2^32 round to u = 1.0 everywhere.

Every function is pure: it takes a seed tensor of any shape and returns
`(new_seed, value)`. The rejection samplers of `rng_mode="reference"`
are not ported yet.
"""

from __future__ import annotations

import math

import torch

from tracer_torch.core import vec

MASK32 = 0xFFFFFFFF
_INV_2_32 = 1.0 / 4294967296.0


def wang_hash(seed: torch.Tensor) -> torch.Tensor:
    """Wang integer mix, bit-exact vs reference include/random_utils.h:7-14."""
    seed = seed.to(torch.int64) & MASK32
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & MASK32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & MASK32
    seed = seed ^ (seed >> 15)
    return seed


def random_float(seed: torch.Tensor):
    """Advance the seed and map to [0, 1]: `u = new_seed / 2**32` in float32."""
    seed = wang_hash(seed)
    return seed, seed.to(torch.float32) * _INV_2_32


def random_unit_vector(seed: torch.Tensor):
    """Uniform direction on the unit sphere; 2 seed advances."""
    seed, u1 = random_float(seed)
    seed, u2 = random_float(seed)
    z = 2.0 * u1 - 1.0
    phi = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return seed, torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _cbrt(u: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt; the float64 power is within an ulp of cbrtf on [0, 1]
    return torch.pow(u.to(torch.float64), 1.0 / 3.0).to(torch.float32)


def random_in_unit_sphere(seed: torch.Tensor):
    """Uniform point in the unit ball: direction times cbrt(u); 3 advances."""
    seed, d = random_unit_vector(seed)
    seed, u = random_float(seed)
    return seed, d * _cbrt(u)[..., None]


def random_in_hemisphere(normal: torch.Tensor, seed: torch.Tensor):
    """Uniform direction in the hemisphere around `normal`; 2 advances."""
    seed, d = random_unit_vector(seed)
    flip = torch.where(vec.dot(d, normal) > 0.0, 1.0, -1.0)
    return seed, d * flip[..., None]


def pixel_seed(i: torch.Tensor, j: torch.Tensor, width: int, reference_quirk: bool = True):
    """Per-pixel base seed: `wang_hash(i*width + j)` with the reference's
    quirk (src/camera.cu:25), else the row-major `wang_hash(j*width + i)`."""
    i = i.to(torch.int64)
    j = j.to(torch.int64)
    lin = i * width + j if reference_quirk else j * width + i
    return wang_hash(lin & MASK32)


def sample_seed(base_pixel_seed: torch.Tensor, s) -> torch.Tensor:
    """Per-sample seed: `wang_hash(base + s)` in uint32. reference: src/camera.cu:28."""
    return wang_hash((base_pixel_seed + s) & MASK32)
