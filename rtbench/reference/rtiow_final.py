"""The final scene of Shirley's "Ray Tracing in One Weekend" (raytracing.github.io,
book 1, v3.2.3, section 13.1 "A Final Render"), worked out from its layout,
and its own plain estimator.

The scene: a ground sphere, the small spheres of the book's 22 x 22 grid
(or the `grid` given) and three large ones, one material each; no emitter;
a sky from white below to (0.5, 0.7, 1.0) above; a thin lens.

The estimator (`render_samples`, with `plain.render_samples`' arguments and
its raw float32 sums) takes the book's camera, sky and materials on the
port's stream: wang_hash streams per (pixel, global sample), two jitter
draws, two lens draws, then the fixed 8-draw budget each bounce (u_choice,
hemisphere 2, ball 3, u_refl, u_rr), and brute nearest hit over every
sphere (plain.nearest_hit). It imports torch, NumPy and plain.py only:
nothing of the program it judges.

Departures from the book, each the program's too:
- the book's y-up world in the port's z-up frame, (x, y, z) -> (x, -z, y),
  a rotation; the eye placed by the camera path's polar form (radius
  sqrt(13^2 + 3^2), angle atan2(-3, 13)), so it lies within float32
  rounding of (13, -3, 2);
- the lens point in polar form, r = R sqrt(u1), theta = 2 pi u2, where the
  book rejects points of a square: the same uniform disk;
- the pixel's sample at its centre plus a jitter in [-0.5, 0.5) of a pixel
  (the book: (i + u) / (W - 1) of the viewport);
- the Lambertian's unit vector is the direction of the budget's ball draw,
  and the metal's fuzz is that ball (the book draws a unit vector by
  normalising a rejected ball point, and a ball point of its own);
- the dielectric leaves its hit point offset by 1e-4 along the normal, to
  the side it goes (the book starts the ray at the point);
- float32 throughout where the book computes in double (sphere roots
  included);
- 484 samples a pixel (a 22 x 22 square) where the book takes 500;
- raw sample sums, which the program's writer quantises with a square-root
  gamma, where the book writes a gamma-2 PPM of the mean.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference import plain

DIELECTRIC, RTIOW_LAMBERTIAN, RTIOW_METAL = plain.DIELECTRIC, 4, 5
NEAR_ZERO_EPS = plain.NEAR_ZERO_EPS
PATH_KEYS = ("rc0", "zc0", "phic0", "arc", "azc", "wrc", "wzc", "wc", "prc", "pzc",
             "rn0", "zn0", "phin0", "arn", "azn", "wrn", "wzn", "wn", "prn", "pzn")


def layout(grid: int, generator_seed: int) -> dict:
    """The book's world (section 13.1) in its own y-up frame, float64: the
    ground, then for a, b in -grid .. grid - 1 the draws choose_mat, the two
    centre offsets and the material's (a diffuse albedo is one random colour
    times another, a metal's albedo is uniform in [0.5, 1) and its fuzz in
    [0, 0.5)), a sphere kept only if it lies more than 0.9 from (4, 0.2, 0);
    then the three large spheres."""
    g = np.random.default_rng(generator_seed)
    center, radius, kind, albedo, fuzz = [(0.0, -1000.0, 0.0)], [1000.0], [RTIOW_LAMBERTIAN], \
        [(0.5, 0.5, 0.5)], [0.0]
    for a in range(-grid, grid):
        for b in range(-grid, grid):
            choose = g.random()
            c = (a + 0.9 * g.random(), 0.2, b + 0.9 * g.random())
            if math.dist(c, (4.0, 0.2, 0.0)) <= 0.9:
                continue
            if choose < 0.8:
                k, alb, fz = RTIOW_LAMBERTIAN, tuple(g.random(3) * g.random(3)), 0.0
            elif choose < 0.95:
                k, alb = RTIOW_METAL, tuple(0.5 + 0.5 * g.random(3))
                fz = 0.5 * g.random()
            else:
                k, alb, fz = DIELECTRIC, (1.0, 1.0, 1.0), 0.0
            center.append(c)
            radius.append(0.2)
            kind.append(k)
            albedo.append(alb)
            fuzz.append(fz)
    for c, k, alb in (((0.0, 1.0, 0.0), DIELECTRIC, (1.0, 1.0, 1.0)),
                      ((-4.0, 1.0, 0.0), RTIOW_LAMBERTIAN, (0.4, 0.2, 0.1)),
                      ((4.0, 1.0, 0.0), RTIOW_METAL, (0.7, 0.6, 0.5))):
        center.append(c)
        radius.append(1.0)
        kind.append(k)
        albedo.append(alb)
        fuzz.append(0.0)
    return dict(center=np.array(center), radius=np.array(radius), kind=np.array(kind),
                albedo=np.array(albedo), fuzz=np.array(fuzz))


def to_port(v):
    """The book's (x, y, z) as the port's (x, -z, y): its up axis y onto z."""
    v = np.asarray(v, np.float64)
    return np.stack([v[..., 0], -v[..., 2], v[..., 1]], axis=-1)


def arrays(inputs: dict) -> dict:
    """plain.scene_from_arrays' arrays: the spheres in the port's frame, one
    material each, no plane (index of refraction 1.5 for glass)."""
    lay = inputs["layout"]
    n = len(lay["radius"])
    z3 = np.zeros((0, 3), np.float32)
    return dict(sphere_center=to_port(lay["center"]).astype(np.float32),
                sphere_radius=lay["radius"].astype(np.float32), sphere_mat=np.arange(n),
                plane_type=np.zeros(0, np.int64), plane_base=z3, plane_u=z3, plane_v=z3,
                plane_mat=np.zeros(0, np.int64), mat_type=lay["kind"],
                mat_fuzz=lay["fuzz"].astype(np.float32),
                mat_ir=np.where(lay["kind"] == DIELECTRIC, 1.5, 1.0).astype(np.float32),
                mat_absorption=np.zeros((n, 3), np.float32),
                mat_albedo=lay["albedo"].astype(np.float32), mat_emit=np.zeros((n, 3), np.float32),
                mat_tex=np.full(n, -1), texture=None)


class Scene(NamedTuple):
    """The spheres as plain.RefScene, and the sky's bottom and top colours."""
    base: plain.RefScene
    sky_bottom: torch.Tensor  # [3]
    sky_top: torch.Tensor


def scene(inputs: dict, device, dtype=torch.float32) -> Scene:
    sky = inputs["sky"]
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)
    return Scene(plain.scene_from_arrays(arrays(inputs), device, dtype), t(sky["bottom"]),
                 t(sky["top"]))


def path(camera: dict) -> dict:
    """The camera's pose as a static camera path in the port's frame: the eye
    by radius, angle and height, the target on the z axis."""
    (fx, fy, fz), (ax, ay, az) = to_port(camera["from"]), to_port(camera["at"])
    if ax or ay:
        raise ValueError("a static path here looks at a point on the z axis")
    p = dict.fromkeys(PATH_KEYS, 0.0)
    p.update(rc0=math.hypot(fx, fy), phic0=math.atan2(fy, fx), zc0=fz, zn0=az)
    return p


def camera(inputs: dict, frame: int, device):
    """(origin, pixel00, delta_u, delta_v, lens `[2, 3]`) in float32 for every
    frame of the static path: plain.camera's look-at basis and viewport,
    with the viewport at the focus distance and the lens basis u, v times
    the radius aperture / 2 (section 12.2)."""
    c, w_px, h_px = inputs["camera"], inputs["width"], inputs["height"]
    eye, at = plain.path_position(path(c), frame, inputs["num_frames"], device)
    vup = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=device)
    h = torch.tan(torch.tensor(c["vfov"], dtype=torch.float32, device=device)
                  * (math.pi / 180.0) / 2.0)
    vh = 2.0 * h
    vw = vh * (float(w_px) / float(h_px))
    focus = c["focus_dist"]
    w = plain._unit(eye - at)
    u = plain._unit(plain._cross(vup, w))
    v = plain._cross(w, u)
    vw, vh = vw * focus, vh * focus
    horizontal, vertical = vw * u, vh * v
    du, dv = horizontal / w_px, -vertical / h_px
    upper_left = eye - focus * w - horizontal / 2.0 + vertical / 2.0
    radius = torch.tensor(c["aperture"] / 2.0, dtype=torch.float32, device=device)
    return eye, upper_left + 0.5 * (du + dv), du, dv, torch.stack([radius * u, radius * v])


def _sky(s: Scene, d, dtype):
    a = plain._dot(d, d)
    uz = d[:, 2] * (1.0 / torch.sqrt(torch.clamp_min(a, 1e-30)))
    t = (0.5 * (uz + 1.0))[:, None]
    return s.sky_bottom * (1.0 - t) + s.sky_top * t


def trace(s: Scene, o, d, seed, max_depth: int, dtype):
    """Radiance [R, 3] of a batch of rays: the sky on a miss, black after
    max_depth bounces; materials DIELECTRIC, RTIOW_LAMBERTIAN, RTIOW_METAL."""
    b = s.base
    if not bool(torch.isin(b.mat_type, torch.tensor(
            [DIELECTRIC, RTIOW_LAMBERTIAN, RTIOW_METAL], device=b.mat_type.device)).all()):
        raise ValueError("this estimator knows the book's three materials only")
    rf = lambda sd: plain.rand(sd, dtype)
    beta = torch.ones_like(o)
    final = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for _ in range(max_depth):
        t, winner = plain.nearest_hit(b, o, d)
        hit, p, n, front, _u, _v, m = plain._record(b, o, d, t, winner)
        final = final + torch.where((alive & ~hit)[:, None], beta * _sky(s, d, dtype),
                                    torch.zeros_like(beta))
        active = alive & hit
        mtype, fuzz, ir, albedo = b.mat_type[m], b.mat_fuzz[m], b.mat_ir[m], b.mat_albedo[m]
        # the fixed budget: u_choice, hemisphere (2), ball (3), u_refl, u_rr
        seed, _u_choice = rf(seed)
        seed, _hemi = plain._unit_vector(rf, seed)
        seed, ball_dir = plain._unit_vector(rf, seed)
        seed, ub = rf(seed)
        ball = ball_dir * torch.pow(ub.double(), 1.0 / 3.0).to(dtype)[:, None]
        seed, u_refl = rf(seed)
        seed, u_rr = rf(seed)
        unit_d = d * torch.rsqrt(torch.clamp_min(plain._dot(d, d), 1e-30))[:, None]
        lam = n + ball_dir
        lam = torch.where(torch.all(lam.abs() < NEAR_ZERO_EPS, -1)[:, None], n, lam)
        refl = unit_d - 2.0 * plain._dot(unit_d, n)[:, None] * n + fuzz[:, None] * ball
        ratio = torch.where(front, 1.0 / ir, ir)
        cos_t = torch.clamp_max(plain._dot(-unit_d, n), 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        schlick = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
        reflect = (ratio * sin_t > 1.0) | (schlick > u_refl)
        perp = ratio[:, None] * (unit_d + cos_t[:, None] * n)
        par = -torch.sqrt(torch.abs(1.0 - plain._dot(perp, perp)))[:, None] * n
        die_d = torch.where(reflect[:, None], unit_d - 2.0 * plain._dot(unit_d, n)[:, None] * n,
                            perp + par)
        dist = torch.sqrt(plain._dot(p - o, p - o))
        die_att = torch.where(front[:, None], torch.ones_like(beta),
                              torch.exp(-b.mat_abs[m] * dist[:, None]))
        p_rr = torch.maximum(die_att[:, 0], torch.maximum(die_att[:, 1], die_att[:, 2]))
        die_att = die_att / torch.clamp_min(p_rr, 1e-30)[:, None]
        side = torch.where(plain._dot(die_d, n) > 0.0, 1.0, -1.0).to(dtype)
        die_o = p + n * (plain.DIELECTRIC_OFFSET * side)[:, None]
        is_l, is_m, is_d = mtype == RTIOW_LAMBERTIAN, mtype == RTIOW_METAL, mtype == DIELECTRIC
        new_d = torch.where(is_l[:, None], lam, torch.where(is_m[:, None], refl, die_d))
        new_o = torch.where(is_d[:, None], die_o, p)
        att = torch.where(is_d[:, None], die_att, albedo)
        ok = is_l | (is_m & (plain._dot(refl, n) > 0.0)) | (is_d & (u_rr <= p_rr))
        live = active & ok
        beta = torch.where(live[:, None], beta * att, beta)
        o = torch.where(live[:, None], new_o, o)
        d = torch.where(live[:, None], new_d, d)
        alive = live
        if not bool(alive.any()):
            break
    return final


def render_samples(s: Scene, cam, width: int, i, j, spp: int, max_depth: int, quirk: bool,
                   dtype=torch.float32, rays_per_batch: int = 0):
    """Raw sample sums [N, 3] (float32) of pixels (i, j) over global samples
    0 .. spp - 1, as plain.render_samples, with the thin lens and the sky."""
    dev = i.device
    origin, p00, du, dv, lens = (x.to(dtype) for x in cam)
    per = rays_per_batch or max(1024, (1 << 24) // max(1, s.base.sph_center.shape[0]))
    base = plain.pixel_seed(i.to(torch.int64), j.to(torch.int64), width, quirk)
    ray_pix = torch.arange(i.shape[0], device=dev).repeat_interleave(spp)
    ray_s = torch.arange(spp, device=dev, dtype=torch.int64).repeat(i.shape[0])
    out = torch.zeros((i.shape[0], 3), dtype=torch.float32, device=dev)
    for r0 in range(0, ray_pix.shape[0], per):
        pix, smp = ray_pix[r0:r0 + per], ray_s[r0:r0 + per]
        seed = plain.wang_hash((base[pix] + smp) & plain.MASK32)
        seed, ox = plain.rand(seed, dtype)
        seed, oy = plain.rand(seed, dtype)
        seed, l1 = plain.rand(seed, dtype)
        seed, l2 = plain.rand(seed, dtype)
        fi, fj = i[pix].to(dtype)[:, None], j[pix].to(dtype)[:, None]
        center = p00 + fi * du + fj * dv
        ps = center + (ox - 0.5)[:, None] * du + (oy - 0.5)[:, None] * dv
        r, theta = torch.sqrt(l1), (2.0 * math.pi) * l2
        o = origin + ((r * torch.cos(theta))[:, None] * lens[0]
                      + (r * torch.sin(theta))[:, None] * lens[1])
        rad = trace(s, o, ps - o, seed, max_depth, dtype)
        out.index_add_(0, pix, rad.to(torch.float32))
    return out
