"""The reference's own deployment, worked out from its config text: a frozen
copy of its parser (src/main.cu:499-550) and scene builder (main.cu:62-497:
cube, octahedron and dodecahedron bodies with metal border quads and
emissive edge spheres, a metal floor quad, point lights as emissive
spheres), in NumPy, and its camera path (camera.cu:303-324).
"""

from __future__ import annotations

import math

import numpy as np

from rtbench.reference import plain

PHI = 1.61803398875
FACE_DIST = {"cube": 1.0 / math.sqrt(3.0), "dodeca": 0.79465447229, "octa": 0.57735026919}

PATH_KEYS = ("rc0", "zc0", "phic0", "arc", "azc", "wrc", "wzc", "wc", "prc", "pzc",
             "rn0", "zn0", "phin0", "arn", "azn", "wrn", "wzn", "wn", "prn", "pzn")


def parse(text: str) -> dict:
    """The config stream: frames, output path, size and fov, the two camera
    paths, 3 bodies, the floor, up to 4 lights, depth and sqrt(spp)."""
    tok = iter(text.split())
    f = lambda: float(next(tok))
    i = lambda: int(next(tok))
    v3 = lambda: (f(), f(), f())
    p = {"num_frames": i(), "output_path": next(tok), "width": i(), "height": i(), "fov": f()}
    p["path"] = {k: f() for k in PATH_KEYS}
    p["bodies"] = [dict(center=v3(), col=v3(), radius=f(), refl=f(), trans=f(), lights=i())
                   for _ in range(3)]
    p["floor"] = dict(corners=[v3() for _ in range(4)], texture=next(tok), tint=v3(), refl=f())
    p["lights"] = [dict(position=v3(), col=v3()) for _ in range(min(i(), 4))]
    p["max_depth"], p["sqrt_spp"] = i(), i()
    return p


class _Buf:
    def __init__(self):
        self.sph, self.pl, self.mat = [], [], []

    def material(self, mtype, fuzz=0.0, ir=1.0, absorption=(0, 0, 0), albedo=(0, 0, 0),
                 emit=(0, 0, 0), tex=-1):
        self.mat.append((mtype, fuzz, ir, absorption, albedo, emit, tex))
        return len(self.mat) - 1

    def plane(self, ptype, base, u, v, m):
        self.pl.append((ptype, np.asarray(base, np.float32), np.asarray(u, np.float32),
                        np.asarray(v, np.float32), m))

    def sphere(self, c, r, m):
        self.sph.append((np.asarray(c, np.float32), float(r), m))


def _unit(v):
    return v / np.linalg.norm(v)


def _edge(buf, center, a, b, r, border, light, n_lights, sr):
    edge = b - a
    radial = _unit((a + b) * 0.5 - center)
    tangent = _unit(np.cross(edge, radial))
    width = r * 0.05
    buf.plane(plain.QUAD, a - tangent * (width * 0.5), edge, tangent * width, border)
    for k in range(n_lights):
        t = (k + 0.5) / n_lights
        buf.sphere((1.0 - t) * a + t * b, sr, light)


def _verts(kind, center, r, verts):
    sr = r * 0.02
    dist = r * FACE_DIST[kind]
    scale = (dist - sr) / dist if dist > sr else 0.0
    dirs = np.stack([_unit(v) for v in np.asarray(verts, np.float32)])
    return center + dirs * r, center + dirs * (r * scale), sr


def _cube(buf, center, r, m, n_lights, border, light):
    out, lit, sr = _verts("cube", center, r, [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                                             [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]])
    for a, b in [(0, 1), (1, 5), (5, 4), (4, 0), (3, 2), (2, 6), (6, 7), (7, 3), (0, 3), (1, 2),
                 (5, 6), (4, 7)]:
        _edge(buf, center, lit[a], lit[b], r, border, light, n_lights, sr)
    for fa, fb, _fc, fd in [(4, 5, 6, 7), (1, 0, 3, 2), (5, 1, 2, 6), (4, 7, 3, 0), (7, 6, 2, 3),
                            (0, 1, 5, 4)]:
        buf.plane(plain.QUAD, out[fa], out[fb] - out[fa], out[fd] - out[fa], m)


def _octa(buf, center, r, m, n_lights, border, light):
    out, lit, sr = _verts("octa", center, r, [[0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
                                             [1, 0, 0], [-1, 0, 0]])
    for a, b, c in [(0, 2, 4), (0, 4, 3), (0, 3, 5), (0, 5, 2), (1, 4, 2), (1, 3, 4), (1, 5, 3),
                    (1, 2, 5)]:
        buf.plane(plain.TRIANGLE, out[a], out[b] - out[a], out[c] - out[a], m)
    for a, b in [(0, 2), (0, 4), (0, 3), (0, 5), (1, 2), (1, 4), (1, 3), (1, 5), (2, 4), (4, 3),
                 (3, 5), (5, 2)]:
        _edge(buf, center, lit[a], lit[b], r, border, light, n_lights, sr)


def _dodeca(buf, center, r, m, n_lights, border, light):
    p, q = PHI, 1.0 / PHI
    out, lit, sr = _verts("dodeca", center, r, [
        [1, 1, 1], [1, 1, -1], [1, -1, 1], [1, -1, -1], [-1, 1, 1], [-1, 1, -1], [-1, -1, 1],
        [-1, -1, -1], [0, p, q], [0, p, -q], [0, -p, q], [0, -p, -q], [q, 0, p], [q, 0, -p],
        [-q, 0, p], [-q, 0, -p], [p, q, 0], [p, -q, 0], [-p, q, 0], [-p, -q, 0]])
    seen = set()
    for face in [(12, 2, 17, 16, 0), (8, 4, 14, 12, 0), (16, 1, 9, 8, 0), (17, 3, 13, 1, 16),
                 (13, 15, 5, 9, 1), (14, 6, 10, 2, 12), (10, 11, 3, 17, 2), (3, 11, 7, 15, 13),
                 (18, 19, 6, 14, 4), (9, 5, 18, 4, 8), (7, 11, 10, 6, 19), (5, 15, 7, 19, 18)]:
        a = out[face[0]]
        for k in (1, 2, 3):
            buf.plane(plain.TRIANGLE, a, out[face[k]] - a, out[face[k + 1]] - a, m)
        for k in range(5):
            key = tuple(sorted((face[k], face[(k + 1) % 5])))
            if key not in seen:
                seen.add(key)
                _edge(buf, center, lit[key[0]], lit[key[1]], r, border, light, n_lights, sr)


def arrays(p: dict, texture) -> dict:
    """The scene's arrays (plain.scene_from_arrays' keys) in the builder's
    append order; `texture` [H, W, 3] float32 or None (untextured floor)."""
    buf = _Buf()
    fl = p["floor"]
    floor = buf.material(plain.METAL, fuzz=fl["refl"], albedo=fl["tint"],
                         tex=0 if (fl["texture"] and texture is not None) else -1)
    l0 = p["lights"][0]["col"] if p["lights"] else (0.0, 0.0, 0.0)
    edge_light = buf.material(plain.DIFFUSE_LIGHT, emit=tuple(0.1 * c for c in l0))
    for k, b in enumerate(p["bodies"]):
        strength = (1.0 - b["trans"]) * 0.5
        body = buf.material(plain.DIELECTRIC, ir=1.0 + b["refl"],
                            absorption=tuple(strength * (1.0 - c) for c in b["col"]))
        border = buf.material(plain.METAL, fuzz=0.6, albedo=(0.5, 0.5, 0.5))
        build = (_octa, _cube, _dodeca)[min(k, 2)]
        build(buf, np.asarray(b["center"], np.float32), b["radius"], body, b["lights"], border,
              edge_light)
    c = [np.asarray(x, np.float32) for x in fl["corners"]]
    buf.plane(plain.QUAD, c[0], c[1] - c[0], c[3] - c[0], floor)
    for light in p["lights"]:
        buf.sphere(light["position"], 1.0, buf.material(plain.DIFFUSE_LIGHT, emit=light["col"]))
    mats = list(zip(*buf.mat))
    return dict(
        sphere_center=np.stack([s[0] for s in buf.sph]), sphere_radius=[s[1] for s in buf.sph],
        sphere_mat=[s[2] for s in buf.sph], plane_type=[x[0] for x in buf.pl],
        plane_base=np.stack([x[1] for x in buf.pl]), plane_u=np.stack([x[2] for x in buf.pl]),
        plane_v=np.stack([x[3] for x in buf.pl]), plane_mat=[x[4] for x in buf.pl],
        mat_type=mats[0], mat_fuzz=mats[1], mat_ir=mats[2], mat_absorption=np.array(mats[3]),
        mat_albedo=np.array(mats[4]), mat_emit=np.array(mats[5]), mat_tex=mats[6],
        texture=texture)


def camera(p: dict, frame: int, device):
    """Frame `frame`'s camera on the path (camera.cu:303-324)."""
    eye, at = plain.path_position(p["path"], frame, p["num_frames"], device)
    return plain.camera(eye, at, p["width"], p["height"], p["fov"], device)
