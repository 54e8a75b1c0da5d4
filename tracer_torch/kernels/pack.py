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
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch

from tracer_torch.bvh import builder as bvh_builder
from tracer_torch.scene.types import Scene

SPHERE_ROWS = ("cx", "cy", "cz", "radius")
PLANE_ROWS = ("nx", "ny", "nz", "d", "bx", "by", "bz", "ptype", "ux", "uy", "uz", "pad0",
              "vx", "vy", "vz", "pad1", "wx", "wy", "wz", "pad2")
JOIN_ROWS = ("mtype", "fuzz", "ir", "abs0", "abs1", "abs2", "alb0", "alb1", "alb2",
             "emi0", "emi1", "emi2", "tex_id")
CAMERA_ROWS = ("ox", "oy", "oz", "p00x", "p00y", "p00z", "dux", "duy", "duz",
               "dvx", "dvy", "dvz", "bgr", "bgg", "bgb")

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


_BVH_CACHE = []  # (weak refs to the BVH's tensors, their versions, num_s, records), newest last
_BVH_CACHE_MAX = 8


def _bvh_records(bvh, num_s: int, max_depth: int) -> torch.Tensor:
    left = bvh.left.detach().cpu().numpy()
    right = bvh.right.detach().cpu().numpy()
    n = left.shape[0]
    if n == 0:
        raise ValueError("the scene's BVH has no nodes")
    bvh_builder.check_stack_capacity(left, right)
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
    tensors = tuple(bvh)
    if any(t.is_inference() for t in tensors):  # no version counter to key on
        return _bvh_records(bvh, scene.num_spheres, max_depth)
    versions = tuple(t._version for t in tensors)
    key = (scene.num_spheres, max_depth)
    for i, (refs, vers, k, rec) in enumerate(_BVH_CACHE):
        if k == key and vers == versions and all(r() is t for r, t in zip(refs, tensors)):
            _BVH_CACHE.append(_BVH_CACHE.pop(i))
            return rec
    rec = _bvh_records(bvh, scene.num_spheres, max_depth)
    _BVH_CACHE.append((tuple(weakref.ref(t) for t in tensors), versions, key, rec))
    del _BVH_CACHE[:-_BVH_CACHE_MAX]
    return rec
