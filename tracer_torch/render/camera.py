"""Camera: look-at basis, viewport, jittered primary rays and the
animation path (port of tracer.render.camera; reference
`Camera::build_camera_data`, src/camera.cu:171-196, and
`CameraData::get_ray`, include/camera.cuh:97-109), with the thin lens of
Shirley's "Ray Tracing in One Weekend" (book 1, v3.2.3, section 12.2):
the viewport at the focus distance and each ray's origin on a disk of the
lens's radius."""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import numpy as np
import torch

from tracer_torch.core import rng, vec

DEFAULT_VUP = (0.0, 0.0, 1.0)  # reference camera.cu:166
DEFAULT_VFOV = 60.0  # reference camera.cuh:132


class CameraData(NamedTuple):
    """Analog of reference CameraData (camera.cuh:86-95): `[3]` float32 each.
    A pinhole: `lens` is None (see ThinLensCamera)."""

    origin: torch.Tensor
    pixel00_loc: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    background: torch.Tensor

    lens = None  # a class attribute, not a field


class ThinLensCamera(CameraData):
    """A CameraData with a thin lens: `lens` `[2, 3]` float32 holds the lens
    basis u and v (the viewport's axes) scaled by the lens radius. The lens
    is an attribute, not a field, so the five fields stay what the pinhole
    passes to everything that takes a camera (the backward pass, the JAX
    package's camera), and every such path refuses a ThinLensCamera
    (kernels/pack.py:rtiow_features)."""

    def __new__(cls, origin, pixel00_loc, pixel_delta_u, pixel_delta_v, background, *, lens):
        self = super().__new__(cls, origin, pixel00_loc, pixel_delta_u, pixel_delta_v,
                               background)
        self.lens = lens
        return self

    def _replace(self, **kw):
        lens = kw.pop("lens", self.lens)
        return ThinLensCamera(*CameraData(*self)._replace(**kw), lens=lens)


def _vec3(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device).reshape(3)


def build_camera_data(origin, look_at, width: int, height: int, vfov=DEFAULT_VFOV,
                      vup=DEFAULT_VUP, background=(0.0, 0.0, 0.0), device="cuda",
                      focus_dist: float = 1.0, aperture: float = 0.0) -> CameraData:
    """reference src/camera.cu:171-196 (look-at basis + viewport), float32.
    The viewport sits at `focus_dist` (1 is the reference's), and
    with `aperture` > 0 the camera is a ThinLensCamera of radius aperture /
    2 (RTIOW section 12.2); the defaults give the pinhole bit for bit."""
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

    # the viewport at the focus distance; a focus_dist of 1 scales by 1.0,
    # which is exact in float32, so the pinhole keeps its rays bit for bit
    viewport_width = viewport_width * focus_dist
    viewport_height = viewport_height * focus_dist
    horizontal = viewport_width * u
    vertical = viewport_height * v

    pixel_delta_u = horizontal / width
    pixel_delta_v = -vertical / height  # note the sign (camera.cu:185)
    upper_left = origin - focus_dist * w - horizontal / 2.0 + vertical / 2.0
    pixel00_loc = upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)
    fields = (origin, pixel00_loc, pixel_delta_u, pixel_delta_v, _vec3(background, device))
    if aperture > 0.0:
        radius = torch.tensor(aperture / 2.0, dtype=torch.float32, device=device)
        return ThinLensCamera(*fields, lens=torch.stack([radius * u, radius * v]))
    return CameraData(*fields)


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


def lens_offset(lens, u1, u2):
    """The origin's offset `[R, 3]` on the lens for draws `u1`, `u2`: polar
    coordinates r = sqrt(u1), theta = 2 pi u2 over the basis `lens` (u and
    v times the radius), uniform on the disk; the RTIOW book rejects
    points of a square instead, for the same distribution."""
    r = torch.sqrt(u1)
    theta = (2.0 * math.pi) * u2
    a, b = r * torch.cos(theta), r * torch.sin(theta)
    return a[..., None] * lens[0] + b[..., None] * lens[1]


def get_rays(cam: CameraData, i, j, seed, sample_index=None, sqrt_spp: int = 0):
    """Jittered primary rays for pixel columns `i`, rows `j` (both `[R]`).

    Pixel center plus a uniform offset in [-0.5, 0.5]^2 of a pixel, x drawn
    before y; the direction is not normalized. Returns (seed, origin, dir).
    A ThinLensCamera draws two more, after the jitter's, and moves the
    origin on its lens (`lens_offset`); the ray still passes through the
    jittered point of the viewport, which sits in the plane in focus.

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
    if cam.lens is not None:
        seed, l1 = rng.random_float(seed)
        seed, l2 = rng.random_float(seed)
        origin = origin + lens_offset(cam.lens, l1, l2)
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
    """Camera for animation frame `frame` (camera.cu:303-324), with the
    path's lens (`aperture`, `focus_dist`)."""
    lookfrom, lookat = camera_path_position(path, frame, num_frames, device=device)
    return build_camera_data(lookfrom, lookat, width, height, vfov=float(vfov),
                             background=background, device=device,
                             focus_dist=path.focus_dist, aperture=path.aperture)
