"""The plain path tracer the benchmark judges the program by.

A frozen, self-contained copy of the estimator of the reference binary
(zloyaloha/ray-tracing-practice, src/camera.cu:17-34 and 218-288) as the
port states it: wang_hash streams that depend only on (pixel, global
sample id), the reference's seeding quirk, jittered primary rays, brute
nearest hit over every sphere and plane, the fixed 8-draw scatter budget
(u_choice, hemisphere 2, ball 3, u_refl, u_rr), bilinear floor texture,
raw un-averaged sample sums. It imports torch only: nothing of the
program it judges.

It renders a flat batch of (pixel, sample) rays, so a sample of pixels at
full spp is one batched bounce loop instead of a loop over samples.
`dtype` is the precision of every float: float32 is the reference;
bfloat16, the nearest precision below, is the control that the comparison
has to reject.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

K_INFINITY = 1e32
T_MIN, T_MAX = 1e-3, 1e30
MASK32 = 0xFFFFFFFF
QUAD, ELLIPSE, TRIANGLE = 0, 1, 2
LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT = 0, 1, 2, 3
METAL_SPECULAR_P = 0.8
DIELECTRIC_OFFSET = 1e-4
NEAR_ZERO_EPS = 1e-8
DENOM_EPS = 1e-8


class RefScene(NamedTuple):
    """Primitives and materials as plain arrays; plane normal, d and w are
    worked out here from base, u and v (`scene_from_arrays`)."""
    sph_center: torch.Tensor  # [S, 3]
    sph_radius: torch.Tensor  # [S]
    sph_mat: torch.Tensor  # [S] int64
    pl_type: torch.Tensor  # [P] int64
    pl_base: torch.Tensor
    pl_u: torch.Tensor
    pl_v: torch.Tensor
    pl_normal: torch.Tensor
    pl_d: torch.Tensor
    pl_w: torch.Tensor
    pl_mat: torch.Tensor
    mat_type: torch.Tensor  # [M] int64
    mat_fuzz: torch.Tensor
    mat_ir: torch.Tensor
    mat_abs: torch.Tensor  # [M, 3]
    mat_albedo: torch.Tensor
    mat_emit: torch.Tensor
    mat_tex: torch.Tensor  # [M] int64, -1 untextured
    texture: Optional[torch.Tensor]  # [H, W, 3] or None


def scene_from_arrays(a: dict, device, dtype=torch.float32) -> RefScene:
    """RefScene from host arrays: sphere_center/radius/mat, plane_type/base/
    u/v/mat, mat_type/fuzz/ir/absorption/albedo/emit/tex, texture (or
    None). Plane normal, d and w follow the reference's PlaneData
    constructor (plane.h:19-28) in float32, then take `dtype`."""
    f32 = lambda k, shape: torch.as_tensor(np.asarray(a[k], np.float32).reshape(shape),
                                           device=device)
    i64 = lambda k: torch.as_tensor(np.asarray(a[k], np.int64).reshape(-1), device=device)
    base, u, v = f32("plane_base", (-1, 3)), f32("plane_u", (-1, 3)), f32("plane_v", (-1, 3))
    n = torch.linalg.cross(u, v, dim=-1)
    nn = (n * n).sum(-1)
    normal = n / torch.sqrt(nn)[:, None]
    d = (normal * base).sum(-1)
    w = n / nn[:, None]
    tex = a.get("texture")
    cast = lambda t: t.to(dtype)
    return RefScene(
        cast(f32("sphere_center", (-1, 3))), cast(f32("sphere_radius", (-1,))), i64("sphere_mat"),
        i64("plane_type"), cast(base), cast(u), cast(v), cast(normal), cast(d), cast(w),
        i64("plane_mat"), i64("mat_type"), cast(f32("mat_fuzz", (-1,))), cast(f32("mat_ir", (-1,))),
        cast(f32("mat_absorption", (-1, 3))), cast(f32("mat_albedo", (-1, 3))),
        cast(f32("mat_emit", (-1, 3))), i64("mat_tex"),
        None if tex is None else cast(torch.as_tensor(tex, device=device).to(torch.float32)))


# ---- RNG (include/random_utils.h; src/camera.cu:25-28) ----------------------

def wang_hash(seed):
    seed = seed & MASK32
    seed = (seed ^ 61) ^ (seed >> 16)
    seed = (seed * 9) & MASK32
    seed = seed ^ (seed >> 4)
    seed = (seed * 0x27D4EB2D) & MASK32
    return seed ^ (seed >> 15)


def rand(seed, dtype):
    seed = wang_hash(seed)
    return seed, (seed.to(torch.float32) * (1.0 / 4294967296.0)).to(dtype)


def pixel_seed(i, j, width: int, quirk: bool):
    lin = i * width + j if quirk else j * width + i
    return wang_hash(lin & MASK32)


# ---- camera (src/camera.cu:171-196, 303-315) --------------------------------

def _unit(v):
    return v * torch.rsqrt((v * v).sum(-1))


def camera(origin, look_at, width: int, height: int, vfov: float, device,
           vup=(0.0, 0.0, 1.0)):
    """(origin, pixel00, delta_u, delta_v) in float32, look-at basis and
    viewport as the reference builds them."""
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device).reshape(3)
    origin, look_at, vup = t(origin), t(look_at), t(vup)
    h = torch.tan(torch.tensor(vfov, dtype=torch.float32, device=device) * (math.pi / 180.0) / 2.0)
    vh = 2.0 * h
    vw = vh * (float(width) / float(height))
    w = _unit(origin - look_at)
    u = _unit(_cross(vup, w))
    v = _cross(w, u)
    horizontal, vertical = vw * u, vh * v
    du, dv = horizontal / width, -vertical / height
    upper_left = origin - w - horizontal / 2.0 + vertical / 2.0
    return origin, upper_left + 0.5 * (du + dv), du, dv


def path_position(p: dict, frame: int, num_frames: int, device):
    """The sinusoidal cylindrical camera path: (lookfrom, lookat)."""
    t = (torch.tensor(float(frame), dtype=torch.float32, device=device) / num_frames) * (2.0 * math.pi)

    def point(r0, ar, wr, pr, z0, az, wz, pz, phi0, w):
        r = r0 + ar * torch.sin(wr * t + pr)
        z = z0 + az * torch.sin(wz * t + pz)
        phi = phi0 + w * t
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z])

    eye = point(p["rc0"], p["arc"], p["wrc"], p["prc"], p["zc0"], p["azc"], p["wzc"], p["pzc"],
                p["phic0"], p["wc"])
    at = point(p["rn0"], p["arn"], p["wrn"], p["prn"], p["zn0"], p["azn"], p["wzn"], p["pzn"],
               p["phin0"], p["wn"])
    return eye, at


# ---- geometry (include/sphere.h, include/plane.h) ---------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def _sphere_t(o, d, c, r):
    oc = o - c
    a = _dot(d, d)
    hb = _dot(oc, d)
    cc = _dot(oc, oc) - r * r
    disc = hb * hb - a * cc
    hit = disc >= 0.0
    sq = torch.sqrt(torch.where(hit, disc, torch.ones_like(disc)))
    inv_a = 1.0 / a
    tn, tf = (-hb - sq) * inv_a, (-hb + sq) * inv_a
    nok = hit & (tn >= T_MIN) & (tn <= T_MAX)
    fok = hit & (tf >= T_MIN) & (tf <= T_MAX)
    inf = torch.full_like(tn, K_INFINITY)
    return torch.where(nok, tn, torch.where(fok, tf, inf))


def _plane_ab(o, d, base, normal, pd, w, u, v):
    denom = _dot(normal, d)
    safe = torch.where(denom.abs() < DENOM_EPS, torch.ones_like(denom), denom)
    root = (pd - _dot(normal, o)) / safe
    phv = o + root[..., None] * d - base
    return denom, root, _dot(w, _cross(phv, v)), _dot(w, _cross(u, phv))


def _interior(ptype, a, b):
    quad = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    ell = (a - 0.5) ** 2 + (b - 0.5) ** 2 <= 0.25
    tri = (a >= 0.0) & (b >= 0.0) & (a + b <= 1.0)
    return torch.where(ptype == QUAD, quad, torch.where(ptype == ELLIPSE, ell, tri))


def _plane_t(o, d, ptype, base, normal, pd, w, u, v):
    denom, root, a, b = _plane_ab(o, d, base, normal, pd, w, u, v)
    ok = (denom.abs() >= DENOM_EPS) & (root >= T_MIN) & (root <= T_MAX) & _interior(ptype, a, b)
    return torch.where(ok, root, torch.full_like(root, K_INFINITY))


def nearest_hit(s: RefScene, o, d):
    """Brute nearest hit: (t [R], winner [R], spheres first, ties to the
    lowest index)."""
    ts = []
    if s.sph_center.shape[0]:
        ts.append(_sphere_t(o[:, None], d[:, None], s.sph_center[None], s.sph_radius[None]))
    if s.pl_base.shape[0]:
        ts.append(_plane_t(o[:, None], d[:, None], s.pl_type[None], s.pl_base[None],
                           s.pl_normal[None], s.pl_d[None], s.pl_w[None], s.pl_u[None],
                           s.pl_v[None]))
    return torch.min(torch.cat(ts, 1), 1)


def _texture(tex, u, v):
    """Bilinear sample with the reference's tex2D_cpu addressing (wrap, v
    flip, truncation, neighbour wrap; include/materials.h:20-51)."""
    th, tw = tex.shape[0], tex.shape[1]
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    px, py = u * tw, (1.0 - v) * th
    x0 = torch.clamp(px.to(torch.int64), 0, tw - 1)
    y0 = torch.clamp(py.to(torch.int64), 0, th - 1)
    x1, y1 = (x0 + 1) % tw, (y0 + 1) % th
    dx, dy = (px - x0.to(px.dtype))[:, None], (py - y0.to(py.dtype))[:, None]
    top = tex[y0, x0] * (1.0 - dx) + tex[y0, x1] * dx
    bot = tex[y1, x0] * (1.0 - dx) + tex[y1, x1] * dx
    return top * (1.0 - dy) + bot * dy


def _record(s: RefScene, o, d, t, winner):
    """The winner's point, face-oriented normal, front face, uv, material."""
    ns = s.sph_center.shape[0]
    hit = t < K_INFINITY
    t = torch.where(hit, t, torch.ones_like(t))
    is_s = winner < ns
    p = o + t[:, None] * d
    if ns:
        si = torch.where(is_s, winner, 0)
        out_s = (p - s.sph_center[si]) / s.sph_radius[si][:, None]
        theta = torch.acos(torch.clamp(out_s[:, 1], -1.0, 1.0))
        phi = torch.atan2(-out_s[:, 2], out_s[:, 0]) + math.pi
        us, vs, ms = phi / (2.0 * math.pi), theta / math.pi, s.sph_mat[si]
    if s.pl_base.shape[0]:
        pi = torch.where(is_s, 0, winner - ns)
        phv = p - s.pl_base[pi]
        up = _dot(s.pl_w[pi], _cross(phv, s.pl_v[pi]))
        vp = _dot(s.pl_w[pi], _cross(s.pl_u[pi], phv))
        out_p, mp = s.pl_normal[pi], s.pl_mat[pi]
    if not ns:
        out, u, v, m = out_p, up, vp, mp
    elif not s.pl_base.shape[0]:
        out, u, v, m = out_s, us, vs, ms
    else:
        out = torch.where(is_s[:, None], out_s, out_p)
        u, v, m = torch.where(is_s, us, up), torch.where(is_s, vs, vp), torch.where(is_s, ms, mp)
    front = _dot(d, out) < 0.0
    normal = torch.where(front[:, None], out, -out)
    return hit, p, normal, front, u, v, m


def _unit_vector(rand_f, seed):
    seed, u1 = rand_f(seed)
    seed, u2 = rand_f(seed)
    z = 2.0 * u1 - 1.0
    phi = (2.0 * math.pi) * u2
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    return seed, torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def trace(s: RefScene, o, d, seed, max_depth: int, dtype):
    """Radiance [R, 3] of a batch of rays (black background, no roulette
    but the dielectric's own), seeds advanced past ray generation."""
    rf = lambda sd: rand(sd, dtype)
    beta = torch.ones_like(o)
    final = torch.zeros_like(o)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    for _ in range(max_depth):
        t, winner = nearest_hit(s, o, d)
        hit, p, n, front, u, v, m = _record(s, o, d, t, winner)
        active = alive & hit
        mtype, fuzz, ir = s.mat_type[m], s.mat_fuzz[m], s.mat_ir[m]
        albedo = s.mat_albedo[m]
        if s.texture is not None:
            textured = s.mat_tex[m] >= 0
            albedo = torch.where(textured[:, None], albedo * _texture(s.texture, u, v), albedo)
        final = final + torch.where(active[:, None], beta * s.mat_emit[m], torch.zeros_like(beta))
        # the fixed budget: u_choice, hemisphere (2), ball (3), u_refl, u_rr
        seed, u_choice = rf(seed)
        seed, hemi = _unit_vector(rf, seed)
        hemi = hemi * torch.where(_dot(hemi, n) > 0.0, 1.0, -1.0).to(dtype)[:, None]
        seed, ball = _unit_vector(rf, seed)
        seed, ub = rf(seed)
        ball = ball * torch.pow(ub.double(), 1.0 / 3.0).to(dtype)[:, None]
        seed, u_refl = rf(seed)
        seed, u_rr = rf(seed)
        unit_d = d * torch.rsqrt(torch.clamp_min(_dot(d, d), 1e-30))[:, None]
        near0 = torch.all(hemi.abs() < NEAR_ZERO_EPS, -1)
        lam = torch.where(near0[:, None], n, hemi)
        spec = u_choice < METAL_SPECULAR_P
        refl = unit_d - 2.0 * _dot(unit_d, n)[:, None] * n + fuzz[:, None] * ball
        metal_d = torch.where(spec[:, None], refl, lam)
        metal_ok = torch.where(spec, _dot(refl, n) > 0.0, True)
        ratio = torch.where(front, 1.0 / ir, ir)
        cos_t = torch.clamp_max(_dot(-unit_d, n), 1.0)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
        r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
        schlick = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
        reflect = (ratio * sin_t > 1.0) | (schlick > u_refl)
        perp = ratio[:, None] * (unit_d + cos_t[:, None] * n)
        par = -torch.sqrt(torch.abs(1.0 - _dot(perp, perp)))[:, None] * n
        die_d = torch.where(reflect[:, None], unit_d - 2.0 * _dot(unit_d, n)[:, None] * n,
                            perp + par)
        dist = torch.sqrt(_dot(p - o, p - o))
        die_att = torch.where(front[:, None], torch.ones_like(beta),
                              torch.exp(-s.mat_abs[m] * dist[:, None]))
        p_rr = torch.maximum(die_att[:, 0], torch.maximum(die_att[:, 1], die_att[:, 2]))
        die_att = die_att / torch.clamp_min(p_rr, 1e-30)[:, None]
        side = torch.where(_dot(die_d, n) > 0.0, 1.0, -1.0).to(dtype)
        die_o = p + n * (DIELECTRIC_OFFSET * side)[:, None]
        is_l, is_m, is_d = mtype == LAMBERTIAN, mtype == METAL, mtype == DIELECTRIC
        new_d = torch.where(is_l[:, None], lam, torch.where(is_m[:, None], metal_d, die_d))
        new_o = torch.where(is_d[:, None], die_o, p)
        att = torch.where(is_d[:, None], die_att, albedo)
        ok = is_l | (is_m & metal_ok) | (is_d & (u_rr <= p_rr))
        live = active & ok
        beta = torch.where(live[:, None], beta * att, beta)
        o = torch.where(live[:, None], new_o, o)
        d = torch.where(live[:, None], new_d, d)
        alive = live
        if not bool(alive.any()):
            break
    return final


def render_samples(s: RefScene, cam, width: int, i, j, spp: int, max_depth: int, quirk: bool,
                   dtype=torch.float32, rays_per_batch: int = 0):
    """Raw sample sums [N, 3] (float32) of pixels (i, j) over global samples
    0 .. spp - 1, one flat batch of N * spp rays, cut into batches of at
    most `rays_per_batch` (default: ~16M primitive tests a batch)."""
    dev = i.device
    origin, p00, du, dv = (x.to(dtype) for x in cam)
    nprim = s.sph_center.shape[0] + s.pl_base.shape[0]
    per = rays_per_batch or max(1024, (1 << 24) // max(1, nprim))
    base = pixel_seed(i.to(torch.int64), j.to(torch.int64), width, quirk)
    ray_pix = torch.arange(i.shape[0], device=dev).repeat_interleave(spp)
    ray_s = torch.arange(spp, device=dev, dtype=torch.int64).repeat(i.shape[0])
    out = torch.zeros((i.shape[0], 3), dtype=torch.float32, device=dev)
    for r0 in range(0, ray_pix.shape[0], per):
        pix, smp = ray_pix[r0:r0 + per], ray_s[r0:r0 + per]
        seed = wang_hash((base[pix] + smp) & MASK32)
        seed, ox = rand(seed, dtype)
        seed, oy = rand(seed, dtype)
        fi, fj = i[pix].to(dtype)[:, None], j[pix].to(dtype)[:, None]
        center = p00 + fi * du + fj * dv
        ps = center + (ox - 0.5)[:, None] * du + (oy - 0.5)[:, None] * dv
        o = origin.expand_as(ps).contiguous()
        rad = trace(s, o, ps - o, seed, max_depth, dtype)
        out.index_add_(0, pix, rad.to(torch.float32))
    return out


def quantize(sums, divisor):
    """The writer's bytes of raw sums (src/camera.cu:64-73): divide, sqrt
    gamma, clamp to [0, 0.999], * 256, truncate."""
    c = np.asarray(sums, np.float32) / np.float32(divisor)
    return (256.0 * np.clip(np.sqrt(np.maximum(c, 0.0)), 0.0, 0.999)).astype(np.uint8)
