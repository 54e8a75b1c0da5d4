"""Scene packing for the CUDA megakernel (port of
tracer/pallas/kernel_lib.py:pack_scene).

Float32 tables on the scene's device. The nearest-hit loop reads each
sphere and plane as one row of an array-of-records table of whole float4s
(16-byte aligned), the shading reads its winner's materials from a
struct-of-arrays table:

  sph  [S, len(SPHERE_ROWS)]  sphere center and radius: one float4
  pla  [P, len(PLANE_ROWS)]   plane normal and d, base and type, u, v, w,
                              each a float4 padded with 0: five float4s
  join [len(JOIN_ROWS), S+P]  each primitive's material (spheres first)

The kernel keeps the direct plane and sphere fields, so the bf16 hi/lo
split rows and the precombined projection tables of the TPU packing (which
exist for its matrix unit) have no counterpart. The field order is part
of the kernel's interface: `csrc/common.cuh` declares the same fields in
its `SphereRow`, `PlaneRow`, `JoinRow` and `CameraRow` enums.

The backward kernel reads one combined table instead (`BWD_ROWS`, built
differentiably by tracer_torch.kernels.bwd.pack_bwd_tables): the join rows
of tracer/pallas/kernel_lib.py (`J_*`, the winner's geometry and
material) followed by the geometry rows of tracer/pallas/bwd.py (`G_*`,
offsets from `JROWS`: the plane d and its texture-uv frame), and the
camera as `CAMV_ROWS`. `csrc/common.cuh` declares the same rows in its
`TableRow` and `CamvRow` enums.

The BVH kernel reads the scene's BVH as `pack_bvh`'s child-pair records,
four float4s (64 bytes) a record, int fields as int32 bits. Record 0 holds
the root as its first child: (box min x, y, z, split axis or -1 for a
leaf), (box max x, y, z, record or primitive id); its other two float4s
are unread zeros. Record r >= 1 belongs to the r-th internal node in node
order and holds its two children in that form, left then right: a child's
box, then its split axis and record if it is internal, or -1 and its
primitive id (spheres first) if it is a leaf. So the kernel tests both
children of a node from one record.

The brute kernels read the scene's objects (`Scene.groups`) as
`pack_groups`' records.

K1-bvh's book instantiations read the camera table with more rows after
the camera's: the RTIOW book's lens and sky (`pack_camera_rtiow`), and
after them book 2's switches, noise, media and motion
(`pack_camera_nextweek`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tracer_torch.bvh import builder as bvh_builder
from tracer_torch.scene.types import RTIOW_LAMBERTIAN, TRIANGLE, Scene
from tracer_torch.utils.tensor_cache import cached

SPHERE_ROWS = ("cx", "cy", "cz", "radius")
PLANE_ROWS = ("nx", "ny", "nz", "d", "bx", "by", "bz", "ptype", "ux", "uy", "uz", "pad0",
              "vx", "vy", "vz", "pad1", "wx", "wy", "wz", "pad2")
JOIN_ROWS = ("mtype", "fuzz", "ir", "abs0", "abs1", "abs2", "alb0", "alb1", "alb2",
             "emi0", "emi1", "emi2", "tex_id")
CAMERA_ROWS = ("ox", "oy", "oz", "p00x", "p00y", "p00z", "dux", "duy", "duz",
               "dvx", "dvy", "dvz", "bgr", "bgg", "bgb")
# K1-bvh's RTIOW instantiation reads these after CAMERA_ROWS: the lens basis
# times its radius (zeros and lens_on 0 for a pinhole), then the sky (sky_on
# 0: the background instead)
RTIOW_ROWS = ("lux", "luy", "luz", "lvx", "lvy", "lvz", "lens_on",
              "sbr", "sbg", "sbb", "str", "stg", "stb", "sky_on")
# K1-bvh's NEXTWEEK instantiation reads these after RTIOW_ROWS
# (pack_camera_nextweek): book 2's switches, then the noise's tables, the
# media (MEDIUM_ROWS each) and the spheres' motion
NEXTWEEK_ROWS = ("motion_on", "num_media", "noise_on", "noise_scale")
NOISE_POINTS = 256  # the Perlin noise's gradient vectors, and each permutation's length
MEDIUM_ROWS = ("cx", "cy", "cz", "radius", "nid", "alb0", "alb1", "alb2")

BWD_JOIN_ROWS = ("cx", "cy", "cz", "rad", "nx", "ny", "nz", "issph", "mtype", "fuzz", "ir",
                 "abs0", "abs1", "abs2", "alb0", "alb1", "alb2", "emi0", "emi1", "emi2", "texid")
BWD_GEO_ROWS = ("pd", "ax", "ay", "az", "bx", "by", "bz", "ba", "bb")
BWD_ROWS = BWD_JOIN_ROWS + BWD_GEO_ROWS
CAMV_ROWS = ("p00x", "p00y", "p00z", "dux", "duy", "duz", "dvx", "dvy", "dvz",
             "ox", "oy", "oz", "bgr", "bgg", "bgb")
(J_CX, J_CY, J_CZ, J_RAD, J_NX, J_NY, J_NZ, J_ISSPH, J_MTYPE, J_FUZZ, J_IR,
 J_ABS0, J_ABS1, J_ABS2, J_ALB0, J_ALB1, J_ALB2, J_EMI0, J_EMI1, J_EMI2, J_TEXID) = range(21)
JROWS = len(BWD_JOIN_ROWS)
G_PD, G_AX, G_AY, G_AZ, G_BX, G_BY, G_BZ, G_BA, G_BB = range(9)
TROWS = len(BWD_ROWS)


class PackedScene(NamedTuple):
    sph: torch.Tensor
    pla: torch.Tensor
    join: torch.Tensor
    num_s: int
    num_p: int


def _rows(*cols):
    return torch.stack([c.to(torch.float32) for c in cols]).contiguous()


def _records(*cols):
    """[N, len(cols)] float32 records, one column per field."""
    return torch.stack([c.to(torch.float32) for c in cols], dim=1).contiguous()


def pack_scene(scene: Scene) -> PackedScene:
    """The kernel's tables for `scene`, on the scene's device."""
    sp, pl, mats = scene.spheres, scene.planes, scene.materials
    sph = _records(*sp.center.unbind(1), sp.radius)
    pad = torch.zeros_like(pl.d)
    pla = _records(*pl.normal.unbind(1), pl.d, *pl.base.unbind(1), pl.ptype,
                   *pl.u.unbind(1), pad, *pl.v.unbind(1), pad, *pl.w.unbind(1), pad)
    midx = torch.cat([sp.material_idx, pl.material_idx]).long()
    join = _rows(mats.mtype[midx], mats.fuzz[midx], mats.ir[midx],
                 *mats.absorption[midx].unbind(1), *mats.albedo[midx].unbind(1),
                 *mats.emit[midx].unbind(1), mats.tex_id[midx])
    return PackedScene(sph, pla, join, scene.num_spheres, scene.num_planes)


def pack_camera(cam) -> torch.Tensor:
    """The camera as one `[len(CAMERA_ROWS)]` float32 tensor on its device."""
    return torch.cat([cam.origin, cam.pixel00_loc, cam.pixel_delta_u, cam.pixel_delta_v,
                      cam.background]).to(torch.float32).contiguous()


def pack_camera_rtiow(cam, scene: Scene) -> torch.Tensor:
    """`[len(CAMERA_ROWS) + len(RTIOW_ROWS)]` float32: pack_camera's rows,
    then the camera's lens and the scene's sky (RTIOW_ROWS)."""
    dev = cam.origin.device
    z3 = torch.zeros(3, dtype=torch.float32, device=dev)
    on = lambda x: torch.full((1,), float(x is not None), dtype=torch.float32, device=dev)
    lens = (z3, z3) if cam.lens is None else tuple(cam.lens)
    sky = (z3, z3) if scene.sky is None else tuple(scene.sky)
    return torch.cat([pack_camera(cam), *lens, on(cam.lens), *sky,
                      on(scene.sky)]).to(torch.float32).contiguous()


def rtiow_features(scene: Scene, cam=None) -> list:
    """What of the RTIOW book's estimator `scene` and `cam` ask for: a thin
    lens, a sky, the material codes RTIOW_LAMBERTIAN or RTIOW_METAL; [] for
    a scene every kernel renders. The codes are read once per materials
    tensor (cached), so a cached call reads nothing from the device."""
    out = []
    if cam is not None and cam.lens is not None:
        out.append("a thin-lens camera")
    if scene.sky is not None:
        out.append("a sky")
    mtype = scene.materials.mtype
    if cached((mtype,), ("rtiow",), lambda: bool((mtype >= RTIOW_LAMBERTIAN).any())):
        out.append("the RTIOW material codes (4, 5)")
    return out


def nextweek_features(scene: Scene) -> list:
    """What of book 2's fields (scene/types.py) `scene` has: moving spheres,
    media, the noise texture; [] for a scene without them."""
    return [name for name, x in (("moving spheres", scene.motion),
                                 ("participating media", scene.media),
                                 ("a noise texture", scene.noise)) if x is not None]


def book_features(scene: Scene, cam=None) -> list:
    """rtiow_features and nextweek_features together: what K1-bvh's book
    instantiations alone render."""
    return rtiow_features(scene, cam) + nextweek_features(scene)


def pack_camera_nextweek(cam, scene: Scene) -> torch.Tensor:
    """`pack_camera_rtiow`'s rows, then book 2's (NEXTWEEK_ROWS: whether
    the spheres move, the media's count, whether there is a noise, its
    scale), the noise's 256 gradient vectors (x, y, z each) and its three
    permutations (as float32, exact), each medium's MEDIUM_ROWS, and with
    motion each sphere's displacement (x, y, z): float32 on the camera's
    device, as K1-bvh's NEXTWEEK instantiation reads them."""
    dev = cam.origin.device
    f = lambda *x: torch.tensor(x, dtype=torch.float32, device=dev)
    media, noise = scene.media, scene.noise
    n_media = 0 if media is None else int(media.radius.shape[0])
    parts = [pack_camera_rtiow(cam, scene),
             f(float(scene.motion is not None), float(n_media), float(noise is not None),
               0.0 if noise is None else noise.scale)]
    if noise is None:
        parts.append(torch.zeros(2 * NOISE_POINTS * 3, dtype=torch.float32, device=dev))
    else:
        parts += [noise.vectors.reshape(-1), noise.perm.reshape(-1)]
    if media is not None:
        parts.append(_records(*media.center.unbind(1), media.radius, media.neg_inv_density,
                              *media.albedo.unbind(1)).reshape(-1))
    if scene.motion is not None:
        parts.append(scene.motion.reshape(-1))
    return torch.cat([p.to(torch.float32) for p in parts]).contiguous()


def _bvh_records(bvh, num_s: int, max_depth: int) -> torch.Tensor:
    left = bvh.left.detach().cpu().numpy()
    right = bvh.right.detach().cpu().numpy()
    n = left.shape[0]
    if n == 0:
        raise ValueError("the scene's BVH has no nodes")
    depth = bvh_builder.tree_depth(left, right)
    if depth > max_depth:
        raise ValueError(f"BVH depth {depth} exceeds the kernel's stack of {max_depth}")
    internal = np.nonzero(left >= 0)[0]
    record = np.zeros(n, np.int32)
    record[internal] = np.arange(1, len(internal) + 1)
    dev = bvh.left.device
    leaf = bvh.left < 0
    # every node as a child: (box min, axis or -1), (box max, record or primitive)
    w_lo = torch.where(leaf, -1, bvh.axis.to(torch.int32)).to(torch.int32)
    prim = torch.where(bvh.kind == 0, bvh.right, num_s + bvh.right)
    w_hi = torch.where(leaf, prim, torch.tensor(record, device=dev)).to(torch.int32)
    lo = torch.cat([bvh.box_min.float(), w_lo.view(torch.float32)[:, None]], dim=1)
    hi = torch.cat([bvh.box_max.float(), w_hi.view(torch.float32)[:, None]], dim=1)
    child = torch.stack([lo, hi], dim=1)  # [n, 2, 4]
    kids = torch.tensor(np.stack([left[internal], right[internal]], axis=1).reshape(-1),
                        dtype=torch.int64, device=dev)
    root = torch.cat([child[0], torch.zeros_like(child[0])])[None]
    return torch.cat([root, child[kids].reshape(-1, 4, 4)]).contiguous()


def pack_bvh(scene: Scene, max_depth: int) -> torch.Tensor:
    """`[I + 1, 4, 4]` float32 child-pair records of `scene.bvh`, I its
    internal nodes (see the module note), on its device, for a kernel whose
    stack holds `max_depth` entries. Checks on the host, once per tree,
    that the tree fits the stack; cached per BVH tensors while they live
    and are not changed in place, so a cached call reads nothing from the
    device."""
    bvh = scene.bvh
    if bvh is None:
        raise ValueError("the scene has no BVH (builders.create_scene(with_bvh=True))")
    return cached(tuple(bvh), ("bvh", scene.num_spheres, max_depth),
                   lambda: _bvh_records(bvh, scene.num_spheres, max_depth))


MAX_GROUPS = 32  # the kernel holds a ray's groups as the bits of one 32-bit mask
GROUP_F4 = 3  # float4s a group record
# A group's ball: its primitives' tight radius R0 times 1 + GROUP_MARGIN,
# plus GROUP_MARGIN_ABS times its centre's distance from the world origin,
# plus the rounding terms, of coefficient GROUP_ROUNDING, that grow with
# the ray origin's distance (csrc/megakernel.cu's note)
GROUP_MARGIN = 2.0**-10
GROUP_MARGIN_ABS = 2.0**-16
GROUP_ROUNDING = 2.0**-18


def _check_groups(groups, num_s: int, num_p: int) -> tuple:
    """`groups` as a tuple of (s_lo, s_hi, p_lo, p_hi) int tuples; raises
    unless each range lies in its table, the ranges of each kind ascend
    without overlapping, and there are at most MAX_GROUPS groups."""
    groups = tuple(tuple(int(x) for x in g) for g in groups or ())
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"{len(groups)} groups: the kernel takes at most {MAX_GROUPS}")
    for kind, (lo, hi), n in (("sphere", (0, 1), num_s), ("plane", (2, 3), num_p)):
        end = 0
        for g in groups:
            if len(g) != 4 or not end <= g[lo] <= g[hi] <= n:
                raise ValueError(f"group {g}: its {kind} range must lie in [{end}, {n}] and "
                                 f"follow the previous group's")
            end = g[hi]
    return groups


def _up(x) -> np.float32:
    """x as float32, rounded up."""
    x32 = np.float32(x)
    return np.nextafter(x32, np.float32(np.inf)) if x32 < x else x32


def _group_records(scene: Scene, groups: tuple) -> torch.Tensor:
    sp, pl = scene.spheres, scene.planes
    center = sp.center.detach().cpu().double().numpy()
    radius = np.abs(sp.radius.detach().cpu().double().numpy())
    base, u, v = (x.detach().cpu().double().numpy() for x in (pl.base, pl.u, pl.v))
    tri = (pl.ptype.detach().cpu().numpy() == TRIANGLE)[:, None]  # no fourth corner
    corners = np.stack([base, base + u, base + v, np.where(tri, base, base + u + v)], axis=1)
    rec = np.zeros((len(groups), GROUP_F4, 4), np.float32)
    for i, (s_lo, s_hi, p_lo, p_hi) in enumerate(groups):
        rec[i, 1] = np.array([s_lo, s_hi, p_lo, p_hi], np.int32).view(np.float32)
        cs, rs = center[s_lo:s_hi], radius[s_lo:s_hi]
        pts = corners[p_lo:p_hi].reshape(-1, 3)
        if len(cs) + len(pts) == 0:
            rec[i, 0, 3] = np.nan  # no primitive: never entered
            continue
        with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
            lo = np.concatenate([cs - rs[:, None], pts]).min(axis=0)
            hi = np.concatenate([cs + rs[:, None], pts]).max(axis=0)
            mid = 0.5 * (lo + hi)
            r0 = max(np.max(np.linalg.norm(cs - mid, axis=1) + rs, initial=0.0),
                     np.max(np.linalg.norm(pts - mid, axis=1), initial=0.0))
            c32 = mid.astype(np.float32)
            cn = np.linalg.norm(mid)
            # the rounding terms at distance D: GROUP_ROUNDING (D + R0)^2 / r_min
            # <= GROUP_ROUNDING (1.25 D^2 + 5 R0^2) / r_min for the spheres, and
            # GROUP_ROUNDING k (D + R0 + |c|) with D <= D^2 / (2 L) + L / 2 for
            # the planes and the test, k one plus the largest 1 / sin of a
            # plane's corner angle
            inv_r = 1.0 / np.min(rs, initial=np.inf)
            uu, vv = u[p_lo:p_hi], v[p_lo:p_hi]
            inv_sin = (np.linalg.norm(uu, axis=1) * np.linalg.norm(vv, axis=1)
                       / np.linalg.norm(np.cross(uu, vv), axis=1))
            k = 1.0 + np.max(inv_sin, initial=0.0)
            ell = r0 if r0 > 0.0 else 1.0
            grow = GROUP_ROUNDING * (1.25 * inv_r + k / (2.0 * ell))
            at0 = GROUP_ROUNDING * (5.0 * r0 * r0 * inv_r + k * (0.5 * ell + r0 + cn))
            r = (r0 * (1.0 + GROUP_MARGIN) + GROUP_MARGIN_ABS * cn + at0
                 + np.linalg.norm(c32.astype(np.float64) - mid))  # and the centre's rounding
        if np.isfinite(c32).all() and np.isfinite(r) and np.isfinite(grow):
            rec[i, 0] = (*c32, _up(r))
            rec[i, 2, 0] = _up(grow)
        else:
            rec[i, 0] = (0.0, 0.0, 0.0, np.inf)  # a primitive not finite: always entered
            rec[i, 2, 0] = 1.0
    return torch.from_numpy(rec).to(scene.device)


def pack_groups(scene: Scene) -> torch.Tensor:
    """`[G, GROUP_F4, 4]` float32 records of `scene.groups` on the scene's
    device, `[0, GROUP_F4, 4]` for `groups=None`: the brute kernels skip a
    group whose ball a ray cannot reach (csrc/megakernel.cu's note says
    why that keeps brute force's answers bit for bit). A record is (ball
    centre x, y, z, radius R at the centre), then the sphere range [s_lo,
    s_hi) and plane range [p_lo, p_hi) as int32 bits, then (A, 0, 0, 0):
    the kernel's ball at a ray origin D from the centre has radius R + A
    D^2. R and A are worked out on the host in float64 from the primitives'
    own geometry (a sphere's centre and radius, a quad's or an ellipse's
    four parallelogram corners, a triangle's three) and the rounding bounds
    of the note, and rounded up; an empty group's R is NaN (never entered),
    a group with a primitive not finite or a sphere of radius 0 gets an
    infinite R (always entered). Cached per geometry tensors while they
    live and are not changed in place, so a cached call reads nothing from
    the device."""
    groups = _check_groups(scene.groups, scene.num_spheres, scene.num_planes)
    if not groups:
        return torch.zeros((0, GROUP_F4, 4), dtype=torch.float32, device=scene.device)
    sp, pl = scene.spheres, scene.planes
    return cached((sp.center, sp.radius, pl.ptype, pl.base, pl.u, pl.v), ("groups", groups),
                   lambda: _group_records(scene, groups))
