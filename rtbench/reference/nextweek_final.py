"""The final scene of Shirley's "Ray Tracing: The Next Week" (raytracing.github.io,
book 2, v3.2.3, section 10 "A Scene Testing All New Features", `final_scene()`
and its case in main.cc), worked out from its layout, and its own plain
estimator.

The scene: a ground of boxes of random heights, a rectangular light (the
only light; the background is black), a moving sphere, a glass and a fuzzed
metal sphere, a glass sphere filled with blue smoke, a thin fog around
everything, an image-textured sphere (the earth), a Perlin marble sphere,
and a cluster of 1,000 small white spheres, rotated and translated.

The estimator (`render_samples`, with `plain.render_samples`' arguments and
its raw float32 sums) takes the book's objects on the port's stream:
wang_hash streams per (pixel, global sample), two jitter draws, one time
draw; then each bounce a brute nearest hit over every sphere (the moving
one at the ray's time) and quad, one free-flight draw a medium in table
order, and the fixed 8-draw budget (u_choice, hemisphere 2, ball 3,
u_refl, u_rr). A medium's interval is its boundary's two roots clamped to
[T_MIN, the nearest surface]; its free flight -ln(u) / density, along the
ray, wins where it ends inside, the nearest such point winning; it
scatters along the budget's ball with the medium's albedo. The brute test
runs over blocks of primitives and on the live rays only, so a sample of
pixels at full spp fits the card. It imports torch, NumPy and plain.py
only: nothing of the program it judges.

Departures from the book, each the program's too:
- the book's y-up world in the port's z-up frame, (x, y, z) -> (x, -z, y),
  a rotation; the eye placed by the camera path's polar form (radius
  hypot(478, 600), angle atan2(600, 478), height 278), so it lies within
  float32 rounding of (478, 600, 278); the noise and the sphere UVs are
  evaluated back in the book's frame;
- every aa_rect (the boxes' six faces, the light) is a quad of the port,
  base + a u + b v with a, b in [0, 1];
- the cluster's rotate_y(15) and translate(-100, 270, 395) applied to its
  centres, which is exact for spheres;
- the earth's texels bilinear, where the book takes the nearest texel;
- the earth's texture drawn from the run's seed (earthmap.jpg is not in
  the repository);
- the draw slots: the time one draw after the jitter's; one free-flight
  draw a medium and query, crossed or not; the isotropic direction the
  budget's ball, the Lambertian's unit vector that ball's direction, the
  metal's fuzz that ball (the book draws its own); a medium's interval
  clamped to the nearest surface of the whole query, where the book tests
  its list in order (the same distribution);
- the pixel's sample at its centre plus a jitter in [-0.5, 0.5) of a
  pixel; a glass ray leaves its hit point offset 1e-4 along the normal;
- float32 throughout where the book computes in double, with each
  sphere's discriminant in its perpendicular form a (r^2 - |l|^2), l = oc
  - (oc.d / a) d (Haines, Guenther and Akenine-Moeller, Ray Tracing Gems,
  ch. 7), which rounds near r^2 where the book's b^2 - a c rounds near
  |oc|^2: without it float32 puts hits on the far cluster spheres inside
  them, and their paths bounce inside to the last bounce;
- 1,024 samples a pixel (a 32 x 32 square) where the book takes 10,000;
- raw sample sums, which the program's writer quantises with a square-root
  gamma, where the book writes a gamma-2 PPM of the mean.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from rtbench.reference import plain

DIELECTRIC, DIFFUSE_LIGHT = plain.DIELECTRIC, plain.DIFFUSE_LIGHT
RTIOW_LAMBERTIAN, RTIOW_METAL, ISOTROPIC = 4, 5, 6
NOISE_TEX = -2  # a material whose albedo takes the marble
NOISE_POINTS = 256
TURB_DEPTH = 7
BLOCK_ELEMS = 1 << 22  # (ray, primitive) pairs a block of the brute test holds
PATH_KEYS = ("rc0", "zc0", "phic0", "arc", "azc", "wrc", "wzc", "wc", "prc", "pzc",
             "rn0", "zn0", "phin0", "arn", "azn", "wrn", "wzn", "wn", "prn", "pzn")


def _permutation(g, n: int) -> np.ndarray:
    """perlin::perlin_generate_perm: 0 .. n-1 shuffled as the book's permute,
    for i = n-1 down to 1 a swap with random_int(0, i)."""
    p = np.arange(n)
    for i in range(n - 1, 0, -1):
        target = int(g.random() * (i + 1))
        p[i], p[target] = p[target], p[i]
    return p


def layout(cfg: dict) -> dict:
    """The book's world in its own y-up frame, float64, drawn from
    numpy.random.default_rng(cfg["generator_seed"]) in the book's order:
    the box heights, random_double(1, 101) each, box by box; the Perlin
    noise's 256 gradient vectors unit_vector(random(-1, 1)) and its
    permutations x, y, z; the cluster's centres random(0, 165), then
    rotated by rotate_y and translated."""
    g = np.random.default_rng(cfg["generator_seed"])
    gr, cl = cfg["ground"], cfg["cluster"]
    n = gr["boxes_per_side"]
    heights = np.array([gr["height_low"] + (gr["height_high"] - gr["height_low"]) * g.random()
                        for _ in range(n * n)]).reshape(n, n)
    vec = np.array([[-1.0 + 2.0 * g.random() for _ in range(3)] for _ in range(NOISE_POINTS)])
    vec = vec / np.linalg.norm(vec, axis=1, keepdims=True)
    perm = np.stack([_permutation(g, NOISE_POINTS) for _ in range(3)])
    local = np.array([[cl["extent"] * g.random() for _ in range(3)] for _ in range(cl["count"])])
    th = math.radians(cl["rotate_y_degrees"])
    cos_t, sin_t = math.cos(th), math.sin(th)
    world = np.stack([cos_t * local[:, 0] + sin_t * local[:, 2], local[:, 1],
                      -sin_t * local[:, 0] + cos_t * local[:, 2]], axis=1) + cl["translate"]
    return dict(heights=heights, noise_vectors=vec, noise_perm=perm, cluster=world)


def to_port(v):
    """The book's (x, y, z) as the port's (x, -z, y): its up axis y onto z."""
    v = np.asarray(v, np.float64)
    return np.stack([v[..., 0], -v[..., 2], v[..., 1]], axis=-1)


def _box_quads(lo, hi):
    """The six faces of the port-frame box [lo, hi] as (base, u, v): at z lo
    and hi (u along x, v along y), at y lo and hi (x, z), at x lo and hi (y,
    z)."""
    (x0, y0, z0), (x1, y1, z1) = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    dx = np.array([x1 - x0, 0, 0], np.float32)
    dy = np.array([0, y1 - y0, 0], np.float32)
    dz = np.array([0, 0, z1 - z0], np.float32)
    return [((x0, y0, z0), dx, dy), ((x0, y0, z1), dx, dy), ((x0, y0, z0), dx, dz),
            ((x0, y1, z0), dx, dz), ((x0, y0, z0), dy, dz), ((x1, y0, z0), dy, dz)]


def ground_boxes(cfg: dict, heights) -> list:
    """Each ground box as (lo, hi) in the port's frame: the book's box from
    (x0 + side i, 0, z0 + side j) to (+ side, height, + side)."""
    gr = cfg["ground"]
    out = []
    n, w = gr["boxes_per_side"], gr["side"]
    for i in range(n):
        for j in range(n):
            x0, z0 = gr["x0"] + i * w, gr["z0"] + j * w
            lo, hi = to_port((x0, 0.0, z0 + w)), to_port((x0 + w, heights[i, j], z0))
            out.append((lo, hi))
    return out


def spheres(cfg: dict, lay: dict) -> list:
    """(book-frame centre, radius, material key) in the scene's sphere
    order: the moving sphere, glass, metal, the smoke's glass boundary, the
    earth, the marble, then the cluster."""
    c = cfg
    out = [(c["moving_sphere"]["center0"], c["moving_sphere"]["radius"], "moving"),
           (c["glass_sphere"]["center"], c["glass_sphere"]["radius"], "glass"),
           (c["metal_sphere"]["center"], c["metal_sphere"]["radius"], "metal"),
           (c["smoke"]["center"], c["smoke"]["radius"], "smoke"),
           (c["earth"]["center"], c["earth"]["radius"], "earth"),
           (c["marble"]["center"], c["marble"]["radius"], "marble")]
    out += [(p, c["cluster"]["radius"], "white") for p in lay["cluster"]]
    return out


def materials(cfg: dict) -> dict:
    """Material key -> (code, albedo, fuzz, index of refraction, emission,
    texture id)."""
    one, zero = (1.0, 1.0, 1.0), (0.0, 0.0, 0.0)
    return {"ground": (RTIOW_LAMBERTIAN, cfg["ground"]["albedo"], 0.0, 1.0, zero, -1),
            "light": (DIFFUSE_LIGHT, zero, 0.0, 1.0, cfg["light"]["emit"], -1),
            "moving": (RTIOW_LAMBERTIAN, cfg["moving_sphere"]["albedo"], 0.0, 1.0, zero, -1),
            "glass": (DIELECTRIC, one, 0.0, cfg["glass_sphere"]["ir"], zero, -1),
            "metal": (RTIOW_METAL, cfg["metal_sphere"]["albedo"], cfg["metal_sphere"]["fuzz"],
                      1.0, zero, -1),
            "smoke": (DIELECTRIC, one, 0.0, cfg["smoke"]["ir"], zero, -1),
            "earth": (RTIOW_LAMBERTIAN, one, 0.0, 1.0, zero, 0),
            "marble": (RTIOW_LAMBERTIAN, one, 0.0, 1.0, zero, NOISE_TEX),
            "white": (RTIOW_LAMBERTIAN, cfg["cluster"]["albedo"], 0.0, 1.0, zero, -1)}


def light_quad(cfg: dict):
    """The light's xz_rect as a port quad (base, u, v)."""
    lt = cfg["light"]
    (xa, xb), (za, zb) = lt["x"], lt["z"]
    base = to_port((xa, lt["y"], zb))
    return base, to_port((xb, lt["y"], zb)) - base, to_port((xa, lt["y"], za)) - base


def arrays(inputs: dict, cfg: dict) -> dict:
    """plain.scene_from_arrays' arrays in the port's frame: the spheres, the
    ground's quads then the light's, one material per key."""
    lay = inputs["layout"]
    mats = materials(cfg)
    keys = list(mats)
    sph = spheres(cfg, lay)
    quads = [q for lo, hi in ground_boxes(cfg, lay["heights"]) for q in _box_quads(lo, hi)]
    pb, pu, pv = zip(*quads, light_quad(cfg))
    col = lambda k: np.array([mats[key][k] for key in keys])
    return dict(sphere_center=to_port(np.array([s[0] for s in sph])).astype(np.float32),
                sphere_radius=np.array([s[1] for s in sph], np.float32),
                sphere_mat=np.array([keys.index(s[2]) for s in sph]),
                plane_type=np.zeros(len(pb), np.int64),
                plane_base=np.array(pb, np.float32), plane_u=np.array(pu, np.float32),
                plane_v=np.array(pv, np.float32),
                plane_mat=np.array([keys.index("ground")] * len(quads) + [keys.index("light")]),
                mat_type=col(0), mat_albedo=col(1).astype(np.float32),
                mat_fuzz=col(2).astype(np.float32), mat_ir=col(3).astype(np.float32),
                mat_emit=col(4).astype(np.float32), mat_tex=col(5),
                mat_absorption=np.zeros((len(keys), 3), np.float32),
                texture=inputs["texture"])


class Scene(NamedTuple):
    """The primitives as plain.RefScene, with the spheres' displacements over
    the shutter, the media (boundary centre and radius, -1 / density,
    albedo) and the noise (gradient vectors, permutations, scale)."""
    base: plain.RefScene
    motion: torch.Tensor  # [S, 3]
    med_center: torch.Tensor  # [M, 3]
    med_radius: torch.Tensor  # [M]
    med_nid: torch.Tensor  # [M]
    med_albedo: torch.Tensor  # [M, 3]
    noise_vectors: torch.Tensor  # [256, 3]
    noise_perm: torch.Tensor  # [3, 256] int64
    noise_scale: float
    background: torch.Tensor  # [3]


def scene(inputs: dict, cfg: dict, device, dtype=torch.float32) -> Scene:
    lay = inputs["layout"]
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)
    base = plain.scene_from_arrays(arrays(inputs, cfg), device, dtype)
    motion = np.zeros((base.sph_radius.shape[0], 3))
    ms = cfg["moving_sphere"]
    motion[0] = to_port(ms["center1"]) - to_port(ms["center0"])
    med = [cfg["smoke"], cfg["fog"]]
    return Scene(base, t(motion), t(to_port([m["center"] for m in med])),
                 t([m["radius"] for m in med]), t([-1.0 / m["density"] for m in med]),
                 t([m["albedo"] for m in med]), t(lay["noise_vectors"]),
                 torch.as_tensor(lay["noise_perm"], dtype=torch.int64, device=device),
                 float(cfg["marble"]["scale"]), t(cfg["background"]))


def path(camera: dict) -> dict:
    """The camera's pose as a static camera path in the port's frame: eye
    and target each by radius, angle and height."""
    (fx, fy, fz), (ax, ay, az) = to_port(camera["from"]), to_port(camera["at"])
    p = dict.fromkeys(PATH_KEYS, 0.0)
    p.update(rc0=math.hypot(fx, fy), phic0=math.atan2(fy, fx), zc0=fz,
             rn0=math.hypot(ax, ay), phin0=math.atan2(ay, ax), zn0=az)
    return p


def camera(inputs: dict, frame: int, device):
    """(origin, pixel00, delta_u, delta_v) in float32 for every frame of the
    static path: plain.camera's look-at basis with the viewport at the
    focus distance (a pinhole: aperture 0)."""
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
    return eye, upper_left + 0.5 * (du + dv), du, dv


# ---- the Perlin marble (book 2, section 5) ------------------------------------------

def _noise(s: Scene, p):
    """perlin::noise at book-frame points p [R, 3]."""
    f = torch.floor(p)
    uvw = p - f
    ijk = f.to(torch.int64)
    hw = uvw * uvw * (3.0 - 2.0 * uvw)
    acc = torch.zeros_like(p[:, 0])
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                g = s.noise_vectors[s.noise_perm[0][(ijk[:, 0] + di) & 255]
                                    ^ s.noise_perm[1][(ijk[:, 1] + dj) & 255]
                                    ^ s.noise_perm[2][(ijk[:, 2] + dk) & 255]]
                wx = hw[:, 0] if di else 1.0 - hw[:, 0]
                wy = hw[:, 1] if dj else 1.0 - hw[:, 1]
                wz = hw[:, 2] if dk else 1.0 - hw[:, 2]
                dot = (g[:, 0] * (uvw[:, 0] - di) + g[:, 1] * (uvw[:, 1] - dj)
                       + g[:, 2] * (uvw[:, 2] - dk))
                acc = acc + wx * wy * wz * dot
    return acc


def turb(s: Scene, p):
    """perlin::turb, 7 octaves, at book-frame points p [R, 3]."""
    acc = torch.zeros_like(p[:, 0])
    weight = 1.0
    for _ in range(TURB_DEPTH):
        acc = acc + weight * _noise(s, p)
        weight *= 0.5
        p = p * 2.0
    return acc.abs()


def marble(s: Scene, point):
    """noise_texture::value at port points: 0.5 (1 + sin(scale z + 10
    turb(p))), p in the book's frame (x, z, -y)."""
    p = torch.stack([point[:, 0], point[:, 2], -point[:, 1]], dim=1)
    return 0.5 * (1.0 + torch.sin(s.noise_scale * p[:, 2] + 10.0 * turb(s, p)))


# ---- nearest hit, media, shading ------------------------------------------------------

def _sphere_t(o, d, c, r):
    """The nearest valid root per (ray, sphere), broadcast, with the
    discriminant's perpendicular form."""
    oc = o - c
    a = plain._dot(d, d)
    inv_a = 1.0 / a
    hb = plain._dot(oc, d)
    lv = oc - d * (hb * inv_a)[..., None]
    disc = a * (r * r - plain._dot(lv, lv))
    hit = disc >= 0.0
    sq = torch.sqrt(torch.where(hit, disc, torch.ones_like(disc)))
    tn, tf = (-hb - sq) * inv_a, (-hb + sq) * inv_a
    nok = hit & (tn >= plain.T_MIN) & (tn <= plain.T_MAX)
    fok = hit & (tf >= plain.T_MIN) & (tf <= plain.T_MAX)
    inf = torch.full_like(tn, plain.K_INFINITY)
    return torch.where(nok, tn, torch.where(fok, tf, inf))


def nearest_hit(s: Scene, o, d, time):
    """Brute nearest hit over every sphere (at the rays' time) and quad, in
    blocks of primitives: (t [R], winner [R], spheres first, ties to the
    lowest index)."""
    b = s.base
    r = o.shape[0]
    best_t = torch.full((r,), plain.K_INFINITY, dtype=o.dtype, device=o.device)
    best_i = torch.zeros(r, dtype=torch.int64, device=o.device)
    blk = max(1, BLOCK_ELEMS // max(1, r))
    ns, npl = b.sph_center.shape[0], b.pl_base.shape[0]

    def fold(ts, k0):
        nonlocal best_t, best_i
        tb, ib = torch.min(ts, 1)
        take = tb < best_t
        best_t = torch.where(take, tb, best_t)
        best_i = torch.where(take, ib + k0, best_i)

    for k0 in range(0, ns, blk):
        c = b.sph_center[k0:k0 + blk][None] + time[:, None, None] * s.motion[k0:k0 + blk][None]
        fold(_sphere_t(o[:, None], d[:, None], c, b.sph_radius[k0:k0 + blk][None]), k0)
    for k0 in range(0, npl, blk):
        sl = slice(k0, k0 + blk)
        fold(plain._plane_t(o[:, None], d[:, None], b.pl_type[sl][None], b.pl_base[sl][None],
                            b.pl_normal[sl][None], b.pl_d[sl][None], b.pl_w[sl][None],
                            b.pl_u[sl][None], b.pl_v[sl][None]), ns + k0)
    return best_t, best_i


def media(s: Scene, o, d, t_surface, seed, dtype):
    """One draw a medium, in table order: (seed, medium [R] or -1, t [R])."""
    a = plain._dot(d, d)
    inv_a = 1.0 / a
    length = torch.sqrt(a)
    best_t = torch.full_like(a, plain.K_INFINITY)
    best_m = torch.full(a.shape, -1, dtype=torch.int64, device=a.device)
    for m in range(s.med_radius.shape[0]):
        seed, u = plain.rand(seed, dtype)
        oc = o - s.med_center[m]
        hb = plain._dot(oc, d)
        lv = oc - d * (hb * inv_a)[..., None]
        disc = a * (s.med_radius[m] * s.med_radius[m] - plain._dot(lv, lv))
        ok = disc >= 0.0
        sq = torch.sqrt(torch.where(ok, disc, torch.ones_like(disc)))
        t0 = torch.clamp_min((-hb - sq) * inv_a, plain.T_MIN)
        t1 = torch.minimum((-hb + sq) * inv_a, t_surface)
        flight = s.med_nid[m] * torch.log(u)
        ok = ok & (t0 < t1) & ~(flight > (t1 - t0) * length)
        t = t0 + flight / length
        take = ok & (t < best_t)
        best_t = torch.where(take, t, best_t)
        best_m = torch.where(take, m, best_m)
    return seed, best_m, best_t


def _record(s: Scene, o, d, t, winner, time):
    """The winner's point, face-oriented normal, front face, uv (book 2's
    sphere UVs in its frame) and material."""
    b = s.base
    ns = b.sph_center.shape[0]
    t = torch.where(t < plain.K_INFINITY, t, torch.ones_like(t))
    is_s = winner < ns
    p = o + t[:, None] * d
    si = torch.where(is_s, winner, 0)
    c = b.sph_center[si] + time[:, None] * s.motion[si]
    out_s = (p - c) / b.sph_radius[si][:, None]
    theta = torch.acos(torch.clamp(-out_s[:, 2], -1.0, 1.0))
    phi = torch.atan2(out_s[:, 1], out_s[:, 0]) + math.pi
    us, vs = phi / (2.0 * math.pi), theta / math.pi
    pi = torch.where(is_s, 0, winner - ns)
    phv = p - b.pl_base[pi]
    up = plain._dot(b.pl_w[pi], plain._cross(phv, b.pl_v[pi]))
    vp = plain._dot(b.pl_w[pi], plain._cross(b.pl_u[pi], phv))
    out = torch.where(is_s[:, None], out_s, b.pl_normal[pi])
    u, v = torch.where(is_s, us, up), torch.where(is_s, vs, vp)
    m = torch.where(is_s, b.sph_mat[si], b.pl_mat[pi])
    front = plain._dot(d, out) < 0.0
    return p, torch.where(front[:, None], out, -out), front, u, v, m


def trace(s: Scene, o, d, time, seed, max_depth: int, dtype):
    """Radiance [R, 3] of a batch of rays; each bounce runs on the rays still
    alive."""
    b = s.base
    rf = lambda sd: plain.rand(sd, dtype)
    final = torch.zeros_like(o)
    beta = torch.ones_like(o)
    live = torch.arange(o.shape[0], device=o.device)
    for _ in range(max_depth):
        t, winner = nearest_hit(s, o, d, time)
        seed, med, mt = media(s, o, d, t, seed, dtype)
        hit = t < plain.K_INFINITY
        scat = med >= 0
        p, n, front, u, v, m = _record(s, o, d, t, winner, time)
        miss = ~hit & ~scat
        final.index_add_(0, live[miss], (beta[miss] * s.background).to(final.dtype))
        surf = hit & ~scat
        emit = torch.where(surf[:, None], beta * b.mat_emit[m], torch.zeros_like(beta))
        final.index_add_(0, live, emit.to(final.dtype))
        mtype, fuzz, ir = b.mat_type[m], b.mat_fuzz[m], b.mat_ir[m]
        tex = b.mat_tex[m]
        albedo = b.mat_albedo[m]
        if b.texture is not None:
            albedo = torch.where((tex >= 0)[:, None], albedo * plain._texture(b.texture, u, v),
                                 albedo)
        albedo = torch.where((tex == NOISE_TEX)[:, None], albedo * marble(s, p)[:, None], albedo)
        # a medium's scatter: its point, ISOTROPIC, its albedo
        ms = torch.clamp_min(med, 0)
        p = torch.where(scat[:, None], o + mt[:, None] * d, p)
        mtype = torch.where(scat, ISOTROPIC, mtype)
        albedo = torch.where(scat[:, None], s.med_albedo[ms], albedo)
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
        lam = torch.where(torch.all(lam.abs() < plain.NEAR_ZERO_EPS, -1)[:, None], n, lam)
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
        side = torch.where(plain._dot(die_d, n) > 0.0, 1.0, -1.0).to(dtype)
        die_o = p + n * (plain.DIELECTRIC_OFFSET * side)[:, None]
        is_l, is_m = mtype == RTIOW_LAMBERTIAN, mtype == RTIOW_METAL
        is_d, is_i = mtype == DIELECTRIC, mtype == ISOTROPIC
        new_d = torch.where(is_l[:, None], lam, torch.where(
            is_m[:, None], refl, torch.where(is_d[:, None], die_d, ball)))
        new_o = torch.where(is_d[:, None], die_o, p)
        ok = is_l | is_i | (is_m & (plain._dot(refl, n) > 0.0)) | (is_d & (u_rr <= 1.0))
        keep = (surf | scat) & ok
        if not bool(keep.any()):
            break
        beta = torch.where(is_d[:, None], beta, beta * albedo)[keep]
        o, d, time, seed, live = new_o[keep], new_d[keep], time[keep], seed[keep], live[keep]
    return final


def render_samples(s: Scene, cam, width: int, i, j, spp: int, max_depth: int, quirk: bool,
                   dtype=torch.float32, rays_per_batch: int = 1 << 16):
    """Raw sample sums [N, 3] (float32) of pixels (i, j) over global samples
    0 .. spp - 1, as plain.render_samples, with the ray time."""
    dev = i.device
    origin, p00, du, dv = (x.to(dtype) for x in cam)
    base = plain.pixel_seed(i.to(torch.int64), j.to(torch.int64), width, quirk)
    ray_pix = torch.arange(i.shape[0], device=dev).repeat_interleave(spp)
    ray_s = torch.arange(spp, device=dev, dtype=torch.int64).repeat(i.shape[0])
    out = torch.zeros((i.shape[0], 3), dtype=torch.float32, device=dev)
    for r0 in range(0, ray_pix.shape[0], rays_per_batch):
        pix, smp = ray_pix[r0:r0 + rays_per_batch], ray_s[r0:r0 + rays_per_batch]
        seed = plain.wang_hash((base[pix] + smp) & plain.MASK32)
        seed, ox = plain.rand(seed, dtype)
        seed, oy = plain.rand(seed, dtype)
        seed, time = plain.rand(seed, dtype)
        fi, fj = i[pix].to(dtype)[:, None], j[pix].to(dtype)[:, None]
        center = p00 + fi * du + fj * dv
        ps = center + (ox - 0.5)[:, None] * du + (oy - 0.5)[:, None] * dv
        o = origin.expand_as(ps).contiguous()
        rad = trace(s, o, ps - o, time, seed, max_depth, dtype)
        out.index_add_(0, pix, rad.to(torch.float32))
    return out
