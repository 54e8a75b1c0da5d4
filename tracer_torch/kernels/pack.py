"""Scene packing for the CUDA megakernel (port of
tracer/pallas/kernel_lib.py:pack_scene).

Flat struct-of-arrays float32 tables, one row per field and one column per
primitive, on the scene's device:

  sph  [len(SPHERE_ROWS), S]  sphere center and radius
  pla  [len(PLANE_ROWS), P]   plane base, u, v, normal, w, d and type
  join [len(JOIN_ROWS), S+P]  each primitive's material (spheres first)

The kernel keeps the direct plane and sphere fields, so the bf16 hi/lo
split rows and the precombined projection tables of the TPU packing (which
exist for its matrix unit) have no counterpart. The row order is part of
the kernel's interface: `csrc/megakernel.cu` declares the same rows in its
`SphereRow`, `PlaneRow`, `JoinRow` and `CameraRow` enums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tracer_torch.scene.types import Scene

SPHERE_ROWS = ("cx", "cy", "cz", "radius")
PLANE_ROWS = ("bx", "by", "bz", "ux", "uy", "uz", "vx", "vy", "vz",
              "nx", "ny", "nz", "wx", "wy", "wz", "d", "ptype")
JOIN_ROWS = ("mtype", "fuzz", "ir", "abs0", "abs1", "abs2", "alb0", "alb1", "alb2",
             "emi0", "emi1", "emi2", "tex_id")
CAMERA_ROWS = ("ox", "oy", "oz", "p00x", "p00y", "p00z", "dux", "duy", "duz",
               "dvx", "dvy", "dvz", "bgr", "bgg", "bgb")


class PackedScene(NamedTuple):
    sph: torch.Tensor
    pla: torch.Tensor
    join: torch.Tensor
    num_s: int
    num_p: int


def _rows(*cols):
    return torch.stack([c.to(torch.float32) for c in cols]).contiguous()


def pack_scene(scene: Scene) -> PackedScene:
    """The kernel's tables for `scene`, on the scene's device."""
    sp, pl, mats = scene.spheres, scene.planes, scene.materials
    sph = _rows(sp.center[:, 0], sp.center[:, 1], sp.center[:, 2], sp.radius)
    pla = _rows(*pl.base.unbind(1), *pl.u.unbind(1), *pl.v.unbind(1),
                *pl.normal.unbind(1), *pl.w.unbind(1), pl.d, pl.ptype)
    midx = torch.cat([sp.material_idx, pl.material_idx]).long()
    join = _rows(mats.mtype[midx], mats.fuzz[midx], mats.ir[midx],
                 *mats.absorption[midx].unbind(1), *mats.albedo[midx].unbind(1),
                 *mats.emit[midx].unbind(1), mats.tex_id[midx])
    return PackedScene(sph, pla, join, scene.num_spheres, scene.num_planes)


def pack_camera(cam) -> torch.Tensor:
    """The camera as one `[len(CAMERA_ROWS)]` float32 tensor on its device."""
    return torch.cat([cam.origin, cam.pixel00_loc, cam.pixel_delta_u, cam.pixel_delta_v,
                      cam.background]).to(torch.float32).contiguous()
