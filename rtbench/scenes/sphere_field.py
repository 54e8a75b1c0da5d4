"""Scene kind `sphere_field`: n non-overlapping spheres on a jittered grid
(every third one a light, the others diffuse and metal) over one floor
quad, seen from one fixed pose. The same construction as the project's
2,000-sphere scene (`prim_scaling.py:build_field`, generator 3); the seed
draws nothing here but the sampled pixels.
"""

from __future__ import annotations

import numpy as np

from rtbench.reference import plain
from rtbench.reference import sphere_field as ref_field
from rtbench.reference.plain import DIFFUSE_LIGHT, LAMBERTIAN, METAL, QUAD


def field_arrays(n: int, generator_seed: int) -> dict:
    g = np.random.default_rng(generator_seed)
    cols = int(np.ceil(np.sqrt(n * 1.25)))
    rows = int(np.ceil(n / cols))
    radii = g.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(cols), np.arange(rows), indexing="ij")
    cell = np.stack([gx.ravel() * 2.0 - (cols - 1.0), gy.ravel() * 2.0 - (rows - 1.0)], -1)[:n]
    slack = (1.0 - radii - 0.02)[:, None]
    centers = np.zeros((n, 3), np.float32)
    centers[:, :2] = cell + g.uniform(-1, 1, size=(n, 2)) * slack
    centers[:, 2] = radii + 0.05 + g.uniform(0, 6, size=(n,))
    half = float(cols + 10)
    return dict(
        sphere_center=centers, sphere_radius=radii, sphere_mat=np.arange(n) % 3,
        plane_type=[QUAD], plane_base=[[-half, -half, 0.0]], plane_u=[[2 * half, 0.0, 0.0]],
        plane_v=[[0.0, 2 * half, 0.0]], plane_mat=[0],
        mat_type=[LAMBERTIAN, METAL, DIFFUSE_LIGHT], mat_fuzz=[0.0, 0.2, 0.0],
        mat_ir=[1.0, 1.0, 1.0], mat_absorption=np.zeros((3, 3), np.float32),
        mat_albedo=[[0.7, 0.5, 0.4], [0.8, 0.8, 0.9], [0.0, 0.0, 0.0]],
        mat_emit=[[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [9.0, 8.0, 7.0]], mat_tex=[-1, -1, -1])


def inputs(cfg: dict, seed: int, device) -> dict:
    return {"arrays": field_arrays(cfg["n"], cfg["generator_seed"]), "camera": cfg["camera"],
            "width": cfg["width"], "height": cfg["height"]}


def program(inp: dict, cfg: dict, device, with_bvh: bool):
    """(scene, SceneParams): the arrays through tracer_torch's scene
    buffers (and its BVH builder), the pose as a static camera path."""
    from tracer_torch.scene import builders
    from tracer_torch.scene.params import CameraPathParams, RenderParams, SceneParams

    a = inp["arrays"]
    buf = builders.SceneBuffers()
    for c, r, m in zip(a["sphere_center"], a["sphere_radius"], a["sphere_mat"]):
        buf.add_sphere(c, r, m)
    for t, b, u, v, m in zip(a["plane_type"], a["plane_base"], a["plane_u"], a["plane_v"],
                             a["plane_mat"]):
        buf.add_plane(t, b, u, v, m)
    for k in range(len(a["mat_type"])):
        buf.add_material(a["mat_type"][k], a["mat_fuzz"][k], a["mat_ir"][k],
                         a["mat_absorption"][k], a["mat_albedo"][k], a["mat_emit"][k],
                         a["mat_tex"][k])
    scene = builders.buffers_to_scene(buf, device, with_bvh=with_bvh)
    cam = cfg["camera"]
    (fx, fy, fz), (ax, ay, az) = cam["from"], cam["at"]
    if fy or ay or ax:
        raise ValueError("a static path here looks from the +x axis at a point on the z axis")
    params = SceneParams(num_frames=cfg["num_frames"], width=cfg["width"], height=cfg["height"],
                         fov_degrees=cam["fov"],
                         camera_path=CameraPathParams(rc0=fx, zc0=fz, zn0=az),
                         render=RenderParams(max_depth=cfg["max_depth"],
                                             sqrt_rays_per_pixel=cfg["sqrt_spp"]))
    return scene, params


def reference(inp: dict, cfg: dict, device, dtype):
    scene = plain.scene_from_arrays(ref_field.arrays(inp), device, dtype)
    settings = {k: cfg[k] for k in ("width", "height", "sqrt_spp", "max_depth", "num_frames")}
    return scene, (lambda n: ref_field.camera(inp, n, device)), settings


def tiny(cfg: dict) -> dict:
    """60 spheres, 24x16 frames of 16 spp at depth 5."""
    return dict(cfg, n=60, width=24, height=16, sqrt_spp=4, max_depth=5)
