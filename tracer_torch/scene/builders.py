"""Host-side scene construction: polyhedron generators + create_scene.

Copy of tracer.scene.builders: the NumPy half is unchanged, and
`create_scene` assembles the port's tensor Scene on an explicit device.

NumPy re-implementation of reference src/main.cu:62-497: three platonic/
archimedean solid generators (cube main.cu:62-129, dodecahedron 134-233,
octahedron 248-308) that emit face planes, metal border quads along
inset edges, and small emissive spheres strung along those edges; plus
`create_scene` (346-497) which derives materials from body/floor/light
params and assembles the Scene.

Loop structure and append order mirror the reference so primitive arrays
are element-for-element comparable.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from tracer_torch.scene import types as T
from tracer_torch.scene.params import SceneParams
from tracer_torch.utils import profiling

PHI = 1.61803398875  # main.cu:131
INV_PHI = 1.0 / PHI

# Inscribed-sphere distance factors (distance from center to a face for a
# unit circumradius): cube 1/sqrt(3) (main.cu:75), dodecahedron
# 0.79465447229 (main.cu:163), octahedron 0.57735026919 (main.cu:263).
CUBE_FACE_DIST = 1.0 / math.sqrt(3.0)
DODECA_FACE_DIST = 0.79465447229
OCTA_FACE_DIST = 0.57735026919

EDGE_WIDTH_FRAC = 0.05  # border quad width = 0.05 r (main.cu:106 etc.)
EDGE_SPHERE_FRAC = 0.02  # light sphere radius = r/100*2 (main.cu:73 etc.)


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


@dataclass
class SceneBuffers:
    """Mutable host-side primitive lists (analog of the host_* vectors
    in main.cu's main)."""

    sphere_center: List = field(default_factory=list)
    sphere_radius: List = field(default_factory=list)
    sphere_mat: List = field(default_factory=list)

    plane_type: List = field(default_factory=list)
    plane_base: List = field(default_factory=list)
    plane_u: List = field(default_factory=list)
    plane_v: List = field(default_factory=list)
    plane_mat: List = field(default_factory=list)

    mat_type: List = field(default_factory=list)
    mat_fuzz: List = field(default_factory=list)
    mat_ir: List = field(default_factory=list)
    mat_absorption: List = field(default_factory=list)
    mat_albedo: List = field(default_factory=list)
    mat_emit: List = field(default_factory=list)
    mat_tex: List = field(default_factory=list)

    # one (s_lo, s_hi, p_lo, p_hi) per polyhedron: its sphere and plane index ranges
    groups: List = field(default_factory=list)
    # sphere k's displacement over the shutter (Scene.motion), for k in the dict
    sphere_motion: dict = field(default_factory=dict)

    def add_sphere(self, center, radius, mat_idx, motion=None):
        """A sphere; with `motion`, one that moves from `center` to `center +
        motion` over the shutter [0, 1) (book 2's moving sphere)."""
        if motion is not None:
            self.sphere_motion[len(self.sphere_radius)] = np.asarray(motion, np.float32)
        self.sphere_center.append(np.asarray(center, np.float32))
        self.sphere_radius.append(float(radius))
        self.sphere_mat.append(int(mat_idx))

    def motion_array(self):
        """`[S, 3]` float32 displacements (0 for a sphere at rest), or None
        where no sphere moves."""
        if not self.sphere_motion:
            return None
        out = np.zeros((len(self.sphere_radius), 3), np.float32)
        for k, m in self.sphere_motion.items():
            out[k] = m
        return out

    def add_plane(self, ptype, base, u, v, mat_idx):
        self.plane_type.append(int(ptype))
        self.plane_base.append(np.asarray(base, np.float32))
        self.plane_u.append(np.asarray(u, np.float32))
        self.plane_v.append(np.asarray(v, np.float32))
        self.plane_mat.append(int(mat_idx))

    def add_material(self, mtype, fuzz=0.0, ir=1.0, absorption=(0, 0, 0),
                     albedo=(0, 0, 0), emit=(0, 0, 0), tex_id=-1) -> int:
        self.mat_type.append(int(mtype))
        self.mat_fuzz.append(float(fuzz))
        self.mat_ir.append(float(ir))
        self.mat_absorption.append(np.asarray(absorption, np.float32))
        self.mat_albedo.append(np.asarray(albedo, np.float32))
        self.mat_emit.append(np.asarray(emit, np.float32))
        self.mat_tex.append(int(tex_id))
        return len(self.mat_type) - 1


def add_box(buf: SceneBuffers, lo, hi, mat_idx):
    """The axis-aligned box [lo, hi] as six QUAD planes (book 2's `box`, its
    six aa_rects): the faces at z lo and hi, y lo and hi, x lo and hi."""
    (x0, y0, z0), (x1, y1, z1) = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    dx, dy, dz = (np.array(v, np.float32) for v in ((x1 - x0, 0, 0), (0, y1 - y0, 0),
                                                    (0, 0, z1 - z0)))
    for base, u, v in (((x0, y0, z0), dx, dy), ((x0, y0, z1), dx, dy),
                       ((x0, y0, z0), dx, dz), ((x0, y1, z0), dx, dz),
                       ((x0, y0, z0), dy, dz), ((x1, y0, z0), dy, dz)):
        buf.add_plane(T.QUAD, np.asarray(base, np.float32), u, v, mat_idx)


def _add_border_edge(buf: SceneBuffers, center, start, end, r, border_mat,
                     light_mat, lights_on_edge, sphere_radius):
    """Shared edge pattern (main.cu:96-116 and twins): a thin quad of
    width 0.05r oriented by cross(edge, radial), plus `lights_on_edge`
    emissive spheres interpolated along the edge."""
    edge_vec = end - start
    mid = (start + end) * 0.5
    radial = _unit(mid - center)
    tangent = _unit(np.cross(edge_vec, radial))
    width = r * EDGE_WIDTH_FRAC
    base = start - tangent * (width * 0.5)
    buf.add_plane(T.QUAD, base, edge_vec, tangent * width, border_mat)
    for i in range(lights_on_edge):
        t = (i + 0.5) / lights_on_edge
        pos = (1.0 - t) * start + t * end
        buf.add_sphere(pos, sphere_radius, light_mat)


def _light_scale(r: float, face_dist_frac: float, sphere_radius: float) -> float:
    """Edge-light inset: (dist_to_face - r_sphere)/dist_to_face
    (main.cu:75-81, 163-168, 263-267)."""
    dist = r * face_dist_frac
    if dist > sphere_radius:
        return (dist - sphere_radius) / dist
    return 0.0


def _body(build):
    """Note the sphere and plane index ranges that a polyhedron's builder
    appends as one group of `buf.groups`."""

    @functools.wraps(build)
    def noted(buf: SceneBuffers, *args, **kwargs):
        s_lo, p_lo = len(buf.sphere_radius), len(buf.plane_type)
        build(buf, *args, **kwargs)
        buf.groups.append((s_lo, len(buf.sphere_radius), p_lo, len(buf.plane_type)))

    return noted


@_body
def add_cube(buf: SceneBuffers, center, r, mat_idx, lights_on_edge,
             border_mat, light_mat):
    """reference main.cu:62-129. Edge borders first, then 6 face quads."""
    center = np.asarray(center, np.float32)
    verts_local = np.array(
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], np.float32
    )
    sphere_radius = r * EDGE_SPHERE_FRAC
    scale = _light_scale(r, CUBE_FACE_DIST, sphere_radius)
    dirs = np.stack([_unit(v) for v in verts_local])
    v_out = center + dirs * r
    v_light = center + dirs * (r * scale)

    edge_pairs = [(0, 1), (1, 5), (5, 4), (4, 0), (3, 2), (2, 6), (6, 7),
                  (7, 3), (0, 3), (1, 2), (5, 6), (4, 7)]
    for a, b in edge_pairs:
        _add_border_edge(buf, center, v_light[a], v_light[b], r, border_mat,
                         light_mat, lights_on_edge, sphere_radius)

    faces = [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6), (4, 7, 3, 0),
             (7, 6, 2, 3), (0, 1, 5, 4)]
    for fa, fb, _fc, fd in faces:
        a, b, d = v_out[fa], v_out[fb], v_out[fd]
        buf.add_plane(T.QUAD, a, b - a, d - a, mat_idx)


@_body
def add_octahedron(buf: SceneBuffers, center, r, mat_idx, lights_on_edge,
                   border_mat, light_mat):
    """reference main.cu:248-308. 8 face triangles, then 12 edge borders."""
    center = np.asarray(center, np.float32)
    verts_local = np.array(
        [[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0]],
        np.float32,
    )
    sphere_radius = r * EDGE_SPHERE_FRAC
    scale = _light_scale(r, OCTA_FACE_DIST, sphere_radius)
    dirs = np.stack([_unit(v) for v in verts_local])
    v_out = center + dirs * r
    v_light = center + dirs * (r * scale)

    tris = [(0, 2, 4), (0, 4, 3), (0, 3, 5), (0, 5, 2),
            (1, 4, 2), (1, 3, 4), (1, 5, 3), (1, 2, 5)]
    for a, b, c in tris:
        buf.add_plane(T.TRIANGLE, v_out[a], v_out[b] - v_out[a], v_out[c] - v_out[a], mat_idx)

    edge_pairs = [(0, 2), (0, 4), (0, 3), (0, 5), (1, 2), (1, 4), (1, 3),
                  (1, 5), (2, 4), (4, 3), (3, 5), (5, 2)]
    for a, b in edge_pairs:
        _add_border_edge(buf, center, v_light[a], v_light[b], r, border_mat,
                         light_mat, lights_on_edge, sphere_radius)


@_body
def add_dodecahedron(buf: SceneBuffers, center, r, mat_idx, lights_on_edge,
                     border_mat, light_mat):
    """reference main.cu:134-233. Per face: 3 triangles (pentagon fan),
    then that face's not-yet-seen edges get borders — tris and border
    quads interleave in the primitive list exactly like the reference."""
    center = np.asarray(center, np.float32)
    p, q = PHI, INV_PHI
    verts_local = np.array(
        [[1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1],
         [-1, 1, 1], [-1, 1, -1], [-1, -1, 1], [-1, -1, -1],
         [0, p, q], [0, p, -q], [0, -p, q], [0, -p, -q],
         [q, 0, p], [q, 0, -p], [-q, 0, p], [-q, 0, -p],
         [p, q, 0], [p, -q, 0], [-p, q, 0], [-p, -q, 0]], np.float32
    )
    faces = [(12, 2, 17, 16, 0), (8, 4, 14, 12, 0), (16, 1, 9, 8, 0),
             (17, 3, 13, 1, 16), (13, 15, 5, 9, 1), (14, 6, 10, 2, 12),
             (10, 11, 3, 17, 2), (3, 11, 7, 15, 13), (18, 19, 6, 14, 4),
             (9, 5, 18, 4, 8), (7, 11, 10, 6, 19), (5, 15, 7, 19, 18)]

    sphere_radius = r * EDGE_SPHERE_FRAC
    scale = _light_scale(r, DODECA_FACE_DIST, sphere_radius)
    dirs = np.stack([_unit(v) for v in verts_local])
    v_out = center + dirs * r
    v_light = center + dirs * (r * scale)

    seen = set()
    for face in faces:
        a = v_out[face[0]]
        for k in (1, 2, 3):
            b, c = v_out[face[k]], v_out[face[k + 1]]
            buf.add_plane(T.TRIANGLE, a, b - a, c - a, mat_idx)
        for i in range(5):
            i1, i2 = face[i], face[(i + 1) % 5]
            key = (min(i1, i2), max(i1, i2))
            if key in seen:
                continue
            seen.add(key)
            _add_border_edge(buf, center, v_light[key[0]], v_light[key[1]], r,
                             border_mat, light_mat, lights_on_edge, sphere_radius)


def build_buffers(params: SceneParams) -> SceneBuffers:
    """Materials + geometry exactly as reference create_scene (main.cu:346-426)."""
    buf = SceneBuffers()

    # Floor: METAL, albedo = tint, fuzz = reflection_coeff (main.cu:349-360).
    floor_mat = buf.add_material(
        T.METAL,
        fuzz=params.floor.reflection_coeff,
        albedo=params.floor.tint,
        tex_id=0 if params.floor.texture_path else -1,
    )

    # Edge-light material: emits lights[0].col * 0.1 (main.cu:363-366).
    l0 = params.lights[0].col if params.lights else (0.0, 0.0, 0.0)
    edge_light_mat = buf.add_material(
        T.DIFFUSE_LIGHT, emit=tuple(0.1 * c for c in l0)
    )

    builders = [add_octahedron, add_cube, add_dodecahedron]
    for i, body in enumerate(params.bodies):
        refl, trans = body.reflection_coeff, body.transparency_coeff
        # DIELECTRIC: ir = 1 + refl; absorption = (1-trans)*0.5*(1-col)
        # per channel (main.cu:375-383).
        strength = (1.0 - trans) * 0.5
        body_mat = buf.add_material(
            T.DIELECTRIC,
            ir=1.0 + refl,
            absorption=tuple(strength * (1.0 - c) for c in body.col),
        )
        border_mat = buf.add_material(T.METAL, fuzz=0.6, albedo=(0.5, 0.5, 0.5))
        builder = builders[i] if i < 2 else add_dodecahedron  # main.cu:386-410
        builder(buf, body.center, body.radius, body_mat, body.lights_on_edge,
                border_mat, edge_light_mat)

    # Floor quad: u = c1-c0, v = c3-c0 (main.cu:413-415).
    c = [np.asarray(x, np.float32) for x in params.floor.corners]
    buf.add_plane(T.QUAD, c[0], c[1] - c[0], c[3] - c[0], floor_mat)

    # Point lights: emissive spheres r = 1.0 (main.cu:417-426).
    for light in params.lights:
        m = buf.add_material(T.DIFFUSE_LIGHT, emit=light.col)
        buf.add_sphere(light.position, 1.0, m)

    return buf


def buffers_to_scene(buf: SceneBuffers, device, textures: Optional[np.ndarray] = None,
                     with_bvh: bool = False) -> T.Scene:
    """Assemble the tensor Scene on `device` from host buffers, with the
    polyhedra's index ranges as `Scene.groups`; with `with_bvh`, also the
    primitives' BVH (tracer_torch.bvh.builder)."""
    with profiling.span("tracer.scene.build"):
        z3 = np.zeros((0, 3), np.float32)
        spheres = T.make_spheres(
            np.stack(buf.sphere_center) if buf.sphere_center else z3,
            buf.sphere_radius, buf.sphere_mat, device)
        planes = T.make_planes(
            buf.plane_type,
            np.stack(buf.plane_base) if buf.plane_base else z3,
            np.stack(buf.plane_u) if buf.plane_u else z3,
            np.stack(buf.plane_v) if buf.plane_v else z3,
            buf.plane_mat, device)
        materials = T.make_materials(
            buf.mat_type, buf.mat_fuzz, buf.mat_ir,
            np.stack(buf.mat_absorption) if buf.mat_absorption else z3,
            np.stack(buf.mat_albedo) if buf.mat_albedo else z3,
            np.stack(buf.mat_emit) if buf.mat_emit else z3,
            buf.mat_tex, device,
        )
        bvh = None
        if with_bvh:
            from tracer_torch.bvh import builder as bvh_builder

            bvh = bvh_builder.build_scene_bvh(buf, device)
        tex = None
        if textures is not None:
            with profiling.span("tracer.scene.texture"):
                tex = torch.tensor(np.asarray(textures, np.float32), device=device)
        motion = buf.motion_array()
        return T.Scene(spheres=spheres, planes=planes, materials=materials, textures=tex,
                       bvh=bvh, groups=tuple(buf.groups) or None,
                       motion=None if motion is None else torch.tensor(motion, device=device))


def create_scene(params: SceneParams, with_bvh: bool = False,
                 texture_loader=None, device="cuda") -> T.Scene:
    """Full analog of reference create_scene (main.cu:346-497).

    `texture_loader(path) -> np.ndarray [H, W, 3] | None` defaults to
    tracer_torch.io.texture.load_texture; a missing file degrades to an
    untextured floor exactly like the reference (main.cu:19-22).
    `with_bvh=True` also builds the primitives' BVH (`Scene.bvh`).
    """
    with profiling.span("tracer.scene.build"):
        buf = build_buffers(params)
        textures = None
        if params.floor.texture_path:
            if texture_loader is None:
                from tracer_torch.io.texture import load_texture as texture_loader
            tex = texture_loader(params.floor.texture_path)
            if tex is not None:
                textures = tex[None]  # single-layer stack
            else:
                buf.mat_tex[0] = -1  # load failed -> untextured (main.cu:19-22)
        return buffers_to_scene(buf, device, textures=textures, with_bvh=with_bvh)
