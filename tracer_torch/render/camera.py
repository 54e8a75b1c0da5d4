"""Camera: look-at basis, viewport, jittered primary rays and the
animation path (port of tracer.render.camera; reference
`Camera::build_camera_data`, src/camera.cu:171-196, and
`CameraData::get_ray`, include/camera.cuh:97-109)."""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch

from tracer_torch.core import rng, vec

DEFAULT_VUP = (0.0, 0.0, 1.0)  # reference camera.cu:166
DEFAULT_VFOV = 60.0  # reference camera.cuh:132


class CameraData(NamedTuple):
    """Analog of reference CameraData (camera.cuh:86-95): `[3]` float32 each."""

    origin: torch.Tensor
    pixel00_loc: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    background: torch.Tensor


def _vec3(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(3)


def build_camera_data(origin, look_at, width: int, height: int, vfov=DEFAULT_VFOV,
                      vup=DEFAULT_VUP, background=(0.0, 0.0, 0.0), device="cuda") -> CameraData:
    """reference src/camera.cu:171-196 (look-at basis + viewport), float32."""
    origin = _vec3(origin, device)
    look_at = _vec3(look_at, device)
    vup = _vec3(vup, device)
    vfov = torch.as_tensor(vfov, dtype=torch.float32, device=device)

    theta = vfov * (math.pi / 180.0)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = viewport_height * (float(width) / float(height))

    w = vec.unit_vector(origin - look_at)
    u = vec.unit_vector(vec.cross(vup, w))
    v = vec.cross(w, u)

    horizontal = viewport_width * u
    vertical = viewport_height * v

    pixel_delta_u = horizontal / width
    pixel_delta_v = -vertical / height  # note the sign (camera.cu:185)
    upper_left = origin - w - horizontal / 2.0 + vertical / 2.0
    pixel00_loc = upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)
    return CameraData(origin, pixel00_loc, pixel_delta_u, pixel_delta_v,
                      _vec3(background, device))


def camera_from_numpy(fields: Mapping[str, np.ndarray], device) -> CameraData:
    """CameraData from host arrays keyed by field name (`"origin"`, ...)."""
    return CameraData(*(torch.tensor(np.asarray(fields[name], np.float32), device=device)
                        for name in CameraData._fields))


def strat_grid(stratify: bool, spp: int, strat_sqrt_spp: int = 0) -> int:
    """The stratification grid size k of a render of `spp` samples: 0 with
    `stratify` off; `strat_sqrt_spp` when given (a chunk of a larger frame
    takes the whole frame's k); else sqrt(spp), which must be square."""
    if not stratify:
        return 0
    if strat_sqrt_spp:
        if not (isinstance(strat_sqrt_spp, int) and strat_sqrt_spp > 0):
            raise ValueError(f"strat_sqrt_spp must be a positive int, got {strat_sqrt_spp!r}")
        return strat_sqrt_spp
    k = math.isqrt(spp)
    if k * k != spp:
        raise ValueError(f"stratify requires a square spp (or strat_sqrt_spp), got {spp}")
    return k


def jitter_offsets(ux, uy, sample_index=None, sqrt_spp: int = 0):
    """The sub-pixel offsets in [-0.5, 0.5) of draws `ux`, `uy`: u - 0.5,
    or, stratified (`sqrt_spp` = k > 0 and the global sample id
    `sample_index`), (cell + u) / k - 0.5 in cell (s mod k, floor(s / k)),
    in float32 as tracer.render.camera.get_rays."""
    if not (sqrt_spp and sample_index is not None):
        return ux - 0.5, uy - 0.5
    k = torch.tensor(float(sqrt_spp), dtype=torch.float32)
    s = torch.tensor(float(sample_index), dtype=torch.float32)  # rounds as uint32 -> f32
    return (torch.fmod(s, k) + ux) / k - 0.5, (torch.floor(s / k) + uy) / k - 0.5


def get_rays(cam: CameraData, i, j, seed, sample_index=None, sqrt_spp: int = 0):
    """Jittered primary rays for pixel columns `i`, rows `j` (both `[R]`).

    Pixel center plus a uniform offset in [-0.5, 0.5]^2 of a pixel, x drawn
    before y; the direction is not normalized. Returns (seed, origin, dir).

    Stratified (`sqrt_spp` = k > 0 with `sample_index`, the global sample
    id s): the jitter is confined to cell (s mod k, floor(s / k)) of a
    k x k sub-pixel grid, offset (cell + u) / k - 0.5, in float32 as
    tracer.render.camera.get_rays; the same two draws, so the rest of the
    stream is unchanged.
    """
    fi = i.to(torch.float32)[..., None]
    fj = j.to(torch.float32)[..., None]
    pixel_center = cam.pixel00_loc + fi * cam.pixel_delta_u + fj * cam.pixel_delta_v
    seed, ox = rng.random_float(seed)
    seed, oy = rng.random_float(seed)
    offset_x, offset_y = jitter_offsets(ox, oy, sample_index, sqrt_spp)
    pixel_sample = (
        pixel_center
        + offset_x[..., None] * cam.pixel_delta_u
        + offset_y[..., None] * cam.pixel_delta_v
    )
    origin = cam.origin.expand_as(pixel_sample)
    return seed, origin, pixel_sample - origin


def camera_path_position(path, frame, num_frames: int, device="cuda"):
    """Sinusoidal cylindrical camera path (reference src/camera.cu:303-315):
    returns (lookfrom `[3]`, lookat `[3]`). `path` is a CameraPathParams."""
    t = (torch.as_tensor(frame, dtype=torch.float32, device=device) / num_frames) * (2.0 * math.pi)
    r_c = path.rc0 + path.arc * torch.sin(path.wrc * t + path.prc)
    z_c = path.zc0 + path.azc * torch.sin(path.wzc * t + path.pzc)
    phi_c = path.phic0 + path.wc * t
    lookfrom = torch.stack([r_c * torch.cos(phi_c), r_c * torch.sin(phi_c), z_c])

    r_n = path.rn0 + path.arn * torch.sin(path.wrn * t + path.prn)
    z_n = path.zn0 + path.azn * torch.sin(path.wzn * t + path.pzn)
    phi_n = path.phin0 + path.wn * t
    lookat = torch.stack([r_n * torch.cos(phi_n), r_n * torch.sin(phi_n), z_n])
    return lookfrom, lookat


def camera_at(path, frame, num_frames, width, height, vfov,
              background=(0.0, 0.0, 0.0), device="cuda") -> CameraData:
    """Camera for animation frame `frame` (camera.cu:303-324)."""
    lookfrom, lookat = camera_path_position(path, frame, num_frames, device=device)
    return build_camera_data(lookfrom, lookat, width, height, vfov=float(vfov),
                             background=background, device=device)
