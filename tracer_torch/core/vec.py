"""Vector math on `[..., 3]` float32 tensors (port of tracer.core.vec).

`_sqrt_grad_safe` is the gradient-safe sqrt of the JAX package: the same
forward values, and a derivative bounded at 0 so that a masked branch
never multiplies a zero cotangent into an infinity.
"""

from __future__ import annotations

import torch

NEAR_ZERO_EPS = 1e-8  # reference: include/vec3.h:59


class _SqrtGradSafe(torch.autograd.Function):
    """sqrt with the derivative `1 / (2 max(sqrt(x), 1e-12))` (the clamped
    derivative of tracer.core.vec._sqrt_grad_safe's custom_jvp)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.sqrt(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g / (2.0 * torch.clamp_min(y, 1e-12))


def _sqrt_grad_safe(x: torch.Tensor) -> torch.Tensor:
    return _SqrtGradSafe.apply(x)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product over the trailing xyz axis. reference: include/vec3.h:99"""
    return torch.sum(a * b, dim=-1)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    return torch.sum(v * v, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    """reference: include/vec3.h:55; gradient bounded at |v| = 0."""
    return _sqrt_grad_safe(length_squared(v))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis. reference: include/vec3.h:101-103"""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def unit_vector(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize over the trailing axis; `eps` floors the squared norm."""
    n2 = length_squared(v)
    if eps:
        n2 = torch.clamp_min(n2, eps)
    return v * torch.rsqrt(n2)[..., None]


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """All components below 1e-8. reference: include/vec3.h:58-61"""
    return torch.all(torch.abs(v) < NEAR_ZERO_EPS, dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """reference: include/vec3.h:63"""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: torch.Tensor, n: torch.Tensor, etai_over_etat: torch.Tensor) -> torch.Tensor:
    """Snell refraction of unit vector `uv` about unit normal `n`
    (reference: include/vec3.h:65-70)."""
    cos_theta = torch.clamp_max(dot(-uv, n), 1.0)
    r_out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = -_sqrt_grad_safe(torch.abs(1.0 - length_squared(r_out_perp)))[..., None] * n
    return r_out_perp + r_out_parallel
