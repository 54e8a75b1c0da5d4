"""Small scenes built with tracer_torch, shared by the port's tests and
chip_smoke.py. Imports torch, numpy and tracer_torch only (no JAX), so the
CUDA tests and the smoke run can use it on a machine without JAX."""

import numpy as np
import torch

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
