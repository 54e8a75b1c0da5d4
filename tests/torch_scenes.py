"""Small scenes built with tracer_torch, shared by the port's tests and
chip_smoke.py. Imports torch, numpy and tracer_torch only (no JAX), so the
CUDA tests and the smoke run can use it on a machine without JAX."""

import numpy as np
import torch

from tracer_torch.render import camera
from tracer_torch.scene import types as T

SKY = (0.05, 0.07, 0.1)  # lights every pixel, so the comparisons see every path


def full_scene(device):
    """Every material and plane type, 8x8 texture on the floor (the scene
    of tests/test_parity.py:_full_scene, built with the port)."""
    g = np.random.default_rng(11)
    tex = g.uniform(0.2, 1.0, size=(1, 8, 8, 3)).astype(np.float32)
    return T.Scene(
        spheres=T.make_spheres([[0.0, 0.0, 1.0], [2.2, 0.0, 1.0], [-2.2, 0.0, 1.0],
                                [0.0, 2.5, 4.0]], [1.0] * 4, [0, 1, 2, 3], device),
        planes=T.make_planes([T.QUAD, T.TRIANGLE, T.ELLIPSE],
                             [[-8, -8, 0], [3, -2, 0.5], [-5, -2, 0.5]],
                             [[16, 0, 0], [2, 0, 0], [2, 0, 0]],
                             [[0, 16, 0], [0, 0, 2], [0, 0, 2]], [4, 0, 0], device),
        materials=T.make_materials(
            [T.LAMBERTIAN, T.METAL, T.DIELECTRIC, T.DIFFUSE_LIGHT, T.METAL],
            [0.0, 0.3, 0.0, 0.0, 0.1], [1.0, 1.0, 1.5, 1.0, 1.0],
            [[0, 0, 0], [0, 0, 0], [0.3, 0.5, 0.1], [0, 0, 0], [0, 0, 0]],
            [[0.7, 0.3, 0.3], [0.8, 0.8, 0.9], [1, 1, 1], [0, 0, 0], [0.9, 0.9, 0.9]],
            [[0, 0, 0], [0, 0, 0], [0, 0, 0], [6, 5, 4], [0, 0, 0]],
            [-1, -1, -1, -1, 0], device),
        textures=torch.tensor(tex, device=device),
    )


def ramp_texture():
    """A 32x32 two-way ramp (tests/test_opt.py's camera-fit texture): texels
    change smoothly with (u, v), so moving a textured surface changes the
    image smoothly."""
    ramp = np.zeros((1, 32, 32, 3), np.float32)
    ramp[0, :, :, 0] = np.linspace(0.1, 1.0, 32)[None, :]
    ramp[0, :, :, 1] = np.linspace(1.0, 0.1, 32)[:, None]
    ramp[0, :, :, 2] = 0.5
    return ramp


def tie_free_scene(device, center_z=1.0, ramp=False):
    """tests/test_grad.py's scene, built with the port: no discrete decision
    flips within +-1e-2 of sphere 0's z at 12x8, spp 2, depth 4. With
    `ramp`, sphere 0 carries ramp_texture(), which gives its z a smooth,
    non-zero gradient (in the untextured scene it is exactly 0)."""
    return T.Scene(
        spheres=T.make_spheres([[0.0, 0.0, center_z], [2.2, 0.0, 1.0], [-2.2, 0.0, 1.0],
                                [0.0, 2.5, 4.0]], [1.0] * 4, [0, 1, 2, 3], device),
        planes=T.make_planes([T.QUAD], [[-8, -8, 0]], [[16, 0, 0]], [[0, 16, 0]], [4], device),
        materials=T.make_materials(
            [T.LAMBERTIAN, T.METAL, T.DIELECTRIC, T.DIFFUSE_LIGHT, T.LAMBERTIAN],
            [0.0, 0.25, 0.0, 0.0, 0.0], [1.0, 1.0, 1.5, 1.0, 1.0],
            [[0, 0, 0], [0, 0, 0], [0.3, 0.5, 0.1], [0, 0, 0], [0, 0, 0]],
            [[0.7, 0.3, 0.3], [0.8, 0.8, 0.9], [1, 1, 1], [0, 0, 0], [0.5, 0.5, 0.5]],
            [[0, 0, 0], [0, 0, 0], [0, 0, 0], [6, 5, 4], [0, 0, 0]],
            [0 if ramp else -1, -1, -1, -1, -1], device),
        textures=torch.tensor(ramp_texture(), device=device) if ramp else None,
    )


def sphere_field_fields(n):
    """benchmarks/prim_scaling.py:build_field(n) as host arrays keyed by
    dotted field path (the input of scene_from_numpy, from which the tests
    also build the JAX twin): n non-overlapping spheres on a jittered grid,
    every third one a light, over one floor quad. At n = 2000 it is
    bench.py's 2000-sphere scene (BASELINE config 5 scale). Returns
    (fields, cols); cols sizes the camera."""
    g = np.random.default_rng(3)
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
    scene = T.Scene(
        spheres=T.make_spheres(centers, radii, np.arange(n) % 3, "cpu"),
        planes=T.make_planes([T.QUAD], [[-half, -half, 0]], [[2 * half, 0, 0]],
                             [[0, 2 * half, 0]], [0], "cpu"),
        materials=T.make_materials(
            [T.LAMBERTIAN, T.METAL, T.DIFFUSE_LIGHT], [0, 0.2, 0], [1, 1, 1], np.zeros((3, 3)),
            [[0.7, 0.5, 0.4], [0.8, 0.8, 0.9], [0, 0, 0]], [[0, 0, 0], [0, 0, 0], [9, 8, 7]],
            [-1] * 3, "cpu"),
        textures=None,
    )
    fields = {f"{group}.{name}": leaf.numpy()
              for group in ("spheres", "planes", "materials")
              for name, leaf in getattr(scene, group)._asdict().items()}
    return fields, cols


def sphere_field(n, device):
    """(scene, cols) of sphere_field_fields(n) on `device`."""
    fields, cols = sphere_field_fields(n)
    return T.scene_from_numpy(fields, device), cols


def sphere_field_camera(cols, width, height, device):
    """benchmarks/prim_scaling.py:cam_for: the field seen from above its
    +x edge."""
    d = cols * 1.6
    return camera.build_camera_data([d, 0.0, d * 0.45], [0.0, 0.0, 3.0], width, height, 55.0,
                                    device=device)


def big_scene(num_spheres, device, seed=0):
    """tests/test_scale.py:_big_scene built with the port (no BVH): spheres
    scattered over a 40x40 patch above a floor quad."""
    g = np.random.default_rng(seed)
    centers = g.uniform(-20, 20, size=(num_spheres, 3)).astype(np.float32)
    centers[:, 2] = g.uniform(0.5, 8, size=num_spheres)
    radii = g.uniform(0.3, 1.2, size=num_spheres).astype(np.float32)
    mat_idx = g.integers(0, 3, size=num_spheres).astype(np.int32)
    return T.Scene(
        spheres=T.make_spheres(centers, radii, mat_idx, device),
        planes=T.make_planes([T.QUAD], [[-30, -30, 0]], [[60, 0, 0]], [[0, 60, 0]], [3], device),
        materials=T.make_materials(
            [T.LAMBERTIAN, T.METAL, T.DIFFUSE_LIGHT, T.LAMBERTIAN], [0, 0.2, 0, 0], [1, 1, 1, 1],
            np.zeros((4, 3)), [[0.6, 0.4, 0.3], [0.8, 0.8, 0.9], [0, 0, 0], [0.5, 0.5, 0.5]],
            [[0, 0, 0], [0, 0, 0], [6, 6, 6], [0, 0, 0]], [-1] * 4, device),
        textures=None,
    )
