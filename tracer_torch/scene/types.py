"""Scene containers: NamedTuples of tensors (port of tracer.scene.types).

Same struct-of-arrays layout and field names as the JAX package: every
per-primitive field is its own `[N, ...]` tensor, float32 for continuous
fields and int32 for type and index codes. All tensors of one Scene live
on one device, chosen by the caller.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

# Plane interior types — reference include/plane.h:7 (enum PlaneType).
QUAD = 0
ELLIPSE = 1
TRIANGLE = 2

# Material types — reference include/materials.h:12 (enum MaterialType).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3
# The materials of Shirley's "Ray Tracing in One Weekend" (book 1, v3.2.3,
# section 9), on the same 8-draw budget: RTIOW_LAMBERTIAN scatters along
# n + the unit direction of the budget's ball draw (n where that sum is
# near zero), RTIOW_METAL reflects plus fuzz times the ball, always (no
# specular gate), killed below the surface.
RTIOW_LAMBERTIAN = 4
RTIOW_METAL = 5

# Reference include/interval.h:3 (kInfinity).
K_INFINITY = 1e32


class Spheres(NamedTuple):
    """SoA of reference `SphereData` (include/sphere.h:8-14)."""

    center: torch.Tensor  # [S, 3] f32
    radius: torch.Tensor  # [S] f32
    material_idx: torch.Tensor  # [S] i32


class Planes(NamedTuple):
    """SoA of reference `PlaneData` (include/plane.h:9-28); `normal`, `d`
    and `w` are precomputed from (base, u, v) as in its constructor."""

    ptype: torch.Tensor  # [P] i32 in {QUAD, ELLIPSE, TRIANGLE}
    base: torch.Tensor  # [P, 3] f32
    u: torch.Tensor  # [P, 3] f32
    v: torch.Tensor  # [P, 3] f32
    normal: torch.Tensor  # [P, 3] f32
    d: torch.Tensor  # [P] f32
    w: torch.Tensor  # [P, 3] f32
    material_idx: torch.Tensor  # [P] i32


class Materials(NamedTuple):
    """SoA of reference `MaterialData` (include/materials.h:53-62);
    `tex_id` -1 means untextured, >= 0 indexes `Scene.textures`."""

    mtype: torch.Tensor  # [M] i32
    fuzz: torch.Tensor  # [M] f32
    ir: torch.Tensor  # [M] f32
    absorption: torch.Tensor  # [M, 3] f32
    albedo: torch.Tensor  # [M, 3] f32
    emit: torch.Tensor  # [M, 3] f32
    tex_id: torch.Tensor  # [M] i32


class BVHArrays(NamedTuple):
    """Flat preorder BVH (port of tracer.scene.types.BVHArrays; reference
    include/bvh.h:7-17, bvh_builder.h:52-120), built on the host by
    tracer_torch.bvh.builder. Leaves: left == -1, right = the primitive's
    index within its kind, kind 0 (sphere) or 1 (plane). Internal nodes:
    left and right are child node indices (left == node + 1: the left
    subtree is allocated first), kind -1, and `axis` the split axis."""

    box_min: torch.Tensor  # [N, 3] f32
    box_max: torch.Tensor  # [N, 3] f32
    left: torch.Tensor  # [N] i32
    right: torch.Tensor  # [N] i32
    kind: torch.Tensor  # [N] i32
    axis: torch.Tensor  # [N] i32


class Sky(NamedTuple):
    """A miss radiance that depends on the direction along the up axis z:
    lerp(bottom, top, 0.5 (unit(d).z + 1)), as the RTIOW book's sky."""

    bottom: torch.Tensor  # [3] f32, straight down
    top: torch.Tensor  # [3] f32, straight up


class Scene(NamedTuple):
    """The scene (analog of reference SceneData, scene.h:9-21); `bvh` is
    the primitives' BVH, or None (builders.create_scene(with_bvh=True)
    builds it). `groups` lists the scene's objects, each as the index
    ranges [s_lo, s_hi) of its spheres and [p_lo, p_hi) of its planes,
    ascending and not overlapping (builders.py notes one per polyhedron),
    or None: the brute kernels' cull (kernels/pack.py:pack_groups).
    `sky`, or None, is what a miss adds in place of the camera's
    background."""

    spheres: Spheres
    planes: Planes
    materials: Materials
    textures: Optional[torch.Tensor]  # [T, Ht, Wt, 3] f32, or None
    bvh: Optional[BVHArrays] = None
    groups: Optional[Tuple[Tuple[int, int, int, int], ...]] = None
    sky: Optional[Sky] = None

    @property
    def num_spheres(self) -> int:
        return self.spheres.center.shape[0]

    @property
    def num_planes(self) -> int:
        return self.planes.base.shape[0]

    @property
    def num_materials(self) -> int:
        return self.materials.albedo.shape[0]

    @property
    def device(self) -> torch.device:
        return self.spheres.center.device


def _f32(x, device, shape):
    return torch.as_tensor(np.asarray(x, np.float32), device=device).reshape(shape)


def _i32(x, device):
    return torch.as_tensor(np.asarray(x, np.int32), device=device).reshape(-1)


def make_spheres(centers, radii, material_idx, device) -> Spheres:
    return Spheres(
        center=_f32(centers, device, (-1, 3)),
        radius=_f32(radii, device, (-1,)),
        material_idx=_i32(material_idx, device),
    )


def make_planes(ptype, base, u, v, material_idx, device) -> Planes:
    """Precompute normal/d/w like PlaneData's ctor (plane.h:19-28), in
    float32 tensor arithmetic as tracer.scene.types.make_planes does."""
    base = _f32(base, device, (-1, 3))
    u = _f32(u, device, (-1, 3))
    v = _f32(v, device, (-1, 3))
    n = torch.linalg.cross(u, v, dim=-1)
    nn = torch.sum(n * n, dim=-1)
    normal = n / torch.sqrt(nn)[..., None]
    return Planes(
        ptype=_i32(ptype, device),
        base=base,
        u=u,
        v=v,
        normal=normal,
        d=torch.sum(normal * base, dim=-1),
        w=n / nn[..., None],
        material_idx=_i32(material_idx, device),
    )


def make_sky(bottom, top, device) -> Sky:
    return Sky(bottom=_f32(bottom, device, (3,)), top=_f32(top, device, (3,)))


def make_materials(mtype, fuzz, ir, absorption, albedo, emit, tex_id, device) -> Materials:
    return Materials(
        mtype=_i32(mtype, device),
        fuzz=_f32(fuzz, device, (-1,)),
        ir=_f32(ir, device, (-1,)),
        absorption=_f32(absorption, device, (-1, 3)),
        albedo=_f32(albedo, device, (-1, 3)),
        emit=_f32(emit, device, (-1, 3)),
        tex_id=_i32(tex_id, device),
    )


def scene_from_numpy(fields: Mapping[str, np.ndarray], device) -> Scene:
    """Scene from host arrays keyed by dotted field path, e.g.
    `"spheres.center"`, `"planes.w"`, `"materials.tex_id"`, plus an
    optional `"textures"` and optional `"bvh.*"` arrays. The arrays are
    taken as they are (no recomputation of derived plane fields, no
    rebuild of the tree), so a scene built by another implementation
    comes across unchanged."""

    def group(cls, prefix):
        return cls(*(torch.tensor(np.asarray(fields[f"{prefix}.{name}"]), device=device)
                     for name in cls._fields))

    tex = fields.get("textures")
    return Scene(
        spheres=group(Spheres, "spheres"),
        planes=group(Planes, "planes"),
        materials=group(Materials, "materials"),
        textures=None if tex is None else torch.tensor(
            np.asarray(tex, np.float32), device=device),
        bvh=group(BVHArrays, "bvh") if "bvh.left" in fields else None,
    )
