"""Stateless counter-based wang_hash streams (port of tracer.core.rng).

torch has few uint32 operations, so a seed here is an int64 tensor that
holds a uint32 value: every step masks with `& 0xFFFFFFFF`. The largest
product, (2^32 - 1) * 0x27D4EB2D, is below 2^63, so nothing overflows and
the streams are bit-exact against the JAX package and the CUDA kernel.

`random_float` converts the 32-bit value to float32 in one rounding
(int64 -> float32), as the XLA path's uint32 -> float32 cast does; values
near 2^32 round to u = 1.0 everywhere.

Two families of samplers: the fixed-budget ones (`random_unit_vector`,
`random_in_unit_sphere`, `random_in_hemisphere`; a fixed number of draws
per call, the stream of `rng_mode="fixed"`) and the reference-stream ones
(`random_in_unit_sphere_rejection`, `random_unit_vector_ref`,
`random_in_hemisphere_ref`; the reference binary's rejection loop,
random_utils.h:25-42, the stream of `rng_mode="reference"`).

Every function is pure: it takes a seed tensor of any shape and returns
`(new_seed, value)`.
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


def random_float_range(seed: torch.Tensor, lo: float, hi: float):
    """`lo + (hi - lo) * u`, one draw. reference: random_utils.h:21-23."""
    seed, u = random_float(seed)
    return seed, lo + (hi - lo) * u


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


def random_ball(seed: torch.Tensor):
    """Uniform point in the unit ball and its unit direction: (seed, the
    direction times cbrt(u), the direction); 3 advances."""
    seed, d = random_unit_vector(seed)
    seed, u = random_float(seed)
    return seed, d * _cbrt(u)[..., None], d


def random_in_unit_sphere(seed: torch.Tensor):
    """Uniform point in the unit ball: direction times cbrt(u); 3 advances."""
    seed, ball, _ = random_ball(seed)
    return seed, ball


def random_in_hemisphere(normal: torch.Tensor, seed: torch.Tensor):
    """Uniform direction in the hemisphere around `normal`; 2 advances."""
    seed, d = random_unit_vector(seed)
    flip = torch.where(vec.dot(d, normal) > 0.0, 1.0, -1.0)
    return seed, d * flip[..., None]


MAX_REJECTION_TRIES = 16  # acceptance ~0.524 a try -> P(miss all) ~ 1e-5


def random_in_unit_sphere_rejection(seed: torch.Tensor, max_tries: int = MAX_REJECTION_TRIES):
    """The reference's rejection loop (random_utils.h:25-32), bounded at
    `max_tries`: each try draws three uniforms in [-1, 1) and accepts the
    point when `x*x + y*y + z*z < 1`; a lane that has accepted stops
    advancing its seed, so its stream is the reference binary's.

    A lane that accepts no try returns the zero vector with its seed
    advanced by 3 * max_tries draws, as tracer's code does (its docstring
    speaks of the last candidate pulled into the ball; the code keeps the
    zero vector it started from).

    The squared length is summed as `(x*x + y*y) + z*z`, one rounding a
    step, in that order on every device: the accept decision steers the
    rest of the stream, and the CUDA kernel rounds it the same way."""
    found = torch.zeros(seed.shape, dtype=torch.bool, device=seed.device)
    val = torch.zeros(seed.shape + (3,), dtype=torch.float32, device=seed.device)
    for _ in range(max_tries):
        s, x = random_float_range(seed, -1.0, 1.0)
        s, y = random_float_range(s, -1.0, 1.0)
        s, z = random_float_range(s, -1.0, 1.0)
        ok = (x * x + y * y) + z * z < 1.0
        take = ok & ~found
        val = torch.where(take[..., None], torch.stack([x, y, z], dim=-1), val)
        seed = torch.where(found, seed, s)  # accepted lanes stop drawing
        found = found | ok
        if bool(found.all()):  # no lane would change any more
            break
    return seed, val


def random_unit_vector_ref(seed: torch.Tensor):
    """reference random_utils.h:34: unit_vector(random_in_unit_sphere)."""
    seed, p = random_in_unit_sphere_rejection(seed)
    return seed, vec.unit_vector(p, eps=1e-24)


def random_in_hemisphere_ref(normal: torch.Tensor, seed: torch.Tensor):
    """reference random_utils.h:36-42 on the rejection stream: the unit
    vector, flipped when it does not point along `normal`."""
    seed, d = random_unit_vector_ref(seed)
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
