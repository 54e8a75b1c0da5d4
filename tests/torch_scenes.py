"""Small scenes built with tracer_torch, shared by the port's tests and
chip_smoke.py. Imports torch, numpy, pytest, tracer_torch and the
benchmark's field (rtbench/scenes/sphere_field.py) only, no JAX, so the
CUDA tests and the smoke run can use it on a machine without JAX.

Every tests/test_torch_*.py module imports `one_torch_thread` from here
(tests/test_torch_scene.py checks it), so each runs on one intra-op
thread."""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from tracer_torch.render import camera
from tracer_torch.scene import types as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.append(ROOT)

from rtbench.scenes.sphere_field import field_arrays  # noqa: E402

SKY = (0.05, 0.07, 0.1)  # lights every pixel, so the comparisons see every path


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test module: the suite runs several worker
    processes, and torch's thread pools in each would oversubscribe the
    cores (small eager ops then spin-wait, many times slower: six copies
    of tests/test_torch_groups.py at once on 8 cores took 15-20 s each on
    one thread, and none ended within 300 s on the default pools)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def within(seconds, fn, *args):
    """fn(*args), waited for at most `seconds` on a daemon thread: a test's
    wait on a writer thread that never drains fails the test, instead of
    holding its test process to the run's time limit."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # raised again in the caller
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        raise TimeoutError(f"{getattr(fn, '__qualname__', fn)} did not return in {seconds} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


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
    """rtbench/scenes/sphere_field.py:field_arrays(n, 3) (the construction
    of benchmarks/prim_scaling.py:build_field(n)) as host arrays keyed by
    dotted field path (the input of scene_from_numpy, from which the tests
    also build the JAX twin): n non-overlapping spheres on a jittered grid,
    every third one a light, over one floor quad. At n = 2000 it is
    bench.py's 2000-sphere scene (BASELINE config 5 scale) and the field of
    rtbench/configs/field_2k.json. Returns (fields, cols); cols sizes the
    camera."""
    a = field_arrays(n, 3)
    scene = T.Scene(
        spheres=T.make_spheres(a["sphere_center"], a["sphere_radius"], a["sphere_mat"], "cpu"),
        planes=T.make_planes(a["plane_type"], a["plane_base"], a["plane_u"], a["plane_v"],
                             a["plane_mat"], "cpu"),
        materials=T.make_materials(a["mat_type"], a["mat_fuzz"], a["mat_ir"],
                                   a["mat_absorption"], a["mat_albedo"], a["mat_emit"],
                                   a["mat_tex"], "cpu"),
        textures=None,
    )
    fields = {f"{group}.{name}": leaf.numpy()
              for group in ("spheres", "planes", "materials")
              for name, leaf in getattr(scene, group)._asdict().items()}
    cols = int(-a["plane_base"][0][0]) - 10  # the floor reaches 10 past the grid's half-width
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


def sky_scene(device):
    """A small sphere and quad behind sky_camera(): every primary ray misses
    and sees SKY, so each sample makes exactly one nearest-hit query."""
    return T.Scene(
        spheres=T.make_spheres([[-50.0, 0.0, 0.0]], [1.0], [0], device),
        planes=T.make_planes([T.QUAD], [[-60, -1, -1]], [[0, 2, 0]], [[0, 0, 2]], [0], device),
        materials=T.make_materials([T.LAMBERTIAN], [0.0], [1.0], np.zeros((1, 3)),
                                   [[0.5, 0.5, 0.5]], [[0, 0, 0]], [-1], device),
        textures=None,
    )


def sky_camera(width, height, device):
    """Looking along +x from the origin, away from sky_scene()'s primitives."""
    return camera.build_camera_data([0.0, 0.0, 0.0], [1.0, 0.0, 0.0], width, height, 60.0,
                                    background=SKY, device=device)


def closed_sphere(device, radius=50.0):
    """One large sphere around the origin, Lambertian with a faint emission
    (so that the frame is not black), and a quad outside it that no ray
    reaches. A camera inside hits the sphere's inward-facing side on every
    bounce and Lambertian never absorbs, so without roulette every path
    runs to max_depth: each sample makes max_depth nearest-hit queries. (A
    scattered ray's origin can round to just outside the sphere, and a
    grazing direction from there misses it: a few bounces in a thousand,
    so a test that counts on every path reaching max_depth picks a shape
    where none does.)"""
    far = 4.0 * radius
    return T.Scene(
        spheres=T.make_spheres([[0.0, 0.0, 0.0]], [radius], [0], device),
        planes=T.make_planes([T.QUAD], [[far, -1, -1]], [[0, 2, 0]], [[0, 0, 2]], [0], device),
        materials=T.make_materials([T.LAMBERTIAN], [0.0], [1.0], np.zeros((1, 3)),
                                   [[0.6, 0.5, 0.4]], [[0.2, 0.2, 0.2]], [-1], device),
        textures=None,
    )


def closed_box(device, half=20.0):
    """Six inward-facing Lambertian quads around the origin, with a faint
    emission: a camera inside hits a wall on every bounce, so without
    roulette its paths run to max_depth, but for rounding: a scattered
    origin just outside a wall and a grazing direction can hit that wall
    again from outside and leave the box, about one bounce in a thousand
    at this size (a third of closed_sphere()'s rate)."""
    h, e = half, 2.0 * half
    corners = [([-h, -h, -h], [e, 0, 0], [0, e, 0]), ([-h, -h, h], [e, 0, 0], [0, e, 0]),
               ([-h, -h, -h], [e, 0, 0], [0, 0, e]), ([-h, h, -h], [e, 0, 0], [0, 0, e]),
               ([-h, -h, -h], [0, e, 0], [0, 0, e]), ([h, -h, -h], [0, e, 0], [0, 0, e])]
    return T.Scene(
        spheres=T.make_spheres(np.zeros((0, 3)), np.zeros(0), np.zeros(0, np.int32), device),
        planes=T.make_planes([T.QUAD] * 6, [c[0] for c in corners], [c[1] for c in corners],
                             [c[2] for c in corners], [0, 0, 1, 1, 2, 2], device),
        materials=T.make_materials(
            [T.LAMBERTIAN] * 3, [0.0] * 3, [1.0] * 3, np.zeros((3, 3)),
            [[0.6, 0.5, 0.4], [0.5, 0.5, 0.5], [0.4, 0.6, 0.4]],
            [[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [0.0, 0.0, 0.0]], [-1] * 3, device),
        textures=None,
    )


# ---- the reference stream's exhausted rejection lanes ----------------------

M32 = 0xFFFFFFFF
# seeds of the first 2^21 on which rng.random_in_unit_sphere_rejection
# accepts none of its 16 tries (it returns the zero vector, 48 draws on)
EXHAUSTED_SEEDS = (44716, 101402, 117565, 139675, 216798, 375787, 592018, 811929, 824724,
                   870972)


def wang_hash_inverse(s: int) -> int:
    """The seed that tracer_torch.core.rng.wang_hash maps to `s` (each of
    its steps is a bijection of the uint32 values)."""
    s &= M32
    s = s ^ (s >> 15) ^ (s >> 30)  # undo s ^= s >> 15
    s = (s * pow(0x27D4EB2D, -1, 2**32)) & M32
    x = s
    for _ in range(8):  # undo s ^= s >> 4
        x = s ^ (x >> 4)
    s = (x * pow(9, -1, 2**32)) & M32
    s ^= 61
    return s ^ (s >> 16)  # undo s = (s ^ 61) ^ (s >> 16)


def sample_start_reaching(seed: int, base: int) -> int:
    """The sample id whose first bounce draws from `seed`: a pixel of base
    seed `base` starts sample s at wang_hash(base + s) and draws its jitter
    twice, so the first scatter sees wang_hash^3(base + s)."""
    x = seed
    for _ in range(3):
        x = wang_hash_inverse(x)
    return (x - base) & M32


def exhausted_lane_view(device):
    """(tie_free_scene(), a one-pixel camera) whose primary ray hits the
    Lambertian floor at (0, 2.5, 0), straight below the light sphere (the
    field of view is 0.01 degrees, so the jitter barely moves the ray): a
    first bounce whose hemisphere sampler exhausts its tries takes the
    normal, +z, and hits the light; a sampled direction rarely does."""
    cam = camera.build_camera_data([3.0, 2.5, 3.0], [0.0, 2.5, 0.0], 1, 1, 0.01,
                                   background=SKY, device=device)
    return tie_free_scene(device), cam
