"""tracer_torch geometry, materials, camera and nearest hit against tracer,
on the same numpy-seeded rays (rtol=1e-5, atol=1e-6: float32 with libm
and reassociation differences in the last places)."""

import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.geometry import plane as jax_plane
from tracer.geometry import sphere as jax_sphere
from tracer.materials import scatter as jax_scatter
from tracer.materials import texture as jax_texture
from tracer.render import camera as jax_camera
from tracer.render import integrator as jax_integrator
from tracer.scene import builders as jax_builders
from tracer.scene import config as jax_config
from tracer_torch.core import T_MAX, T_MIN
from tracer_torch.geometry import plane, sphere
from tracer_torch.materials import scatter, texture
from tracer_torch.render import camera, hit
from tracer_torch.scene import config
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_scene import jax_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6


def close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **({"rtol": RTOL, "atol": ATOL} | kw))


def _rays(n=512, seed=0, targets=None):
    """Random rays; with `targets` ([K, 3]) each aims near one of them."""
    g = np.random.default_rng(seed)
    origin = g.uniform(-6, 6, size=(n, 3)).astype(np.float32)
    if targets is None:
        target = g.uniform(-3, 3, size=(n, 3))
    else:
        target = targets[g.integers(0, len(targets), size=n)] + g.normal(scale=0.1, size=(n, 3))
    return origin, (target - origin).astype(np.float32)


def _canonical():
    text = jax_config.default_config_text()
    jscene = jax_builders.create_scene(jax_config.read_scene_params(io.StringIO(text)),
                                       texture_loader=lambda _p: None)
    return jscene, T.scene_from_numpy(jax_scene_fields(jscene), "cpu")


def _mask_inf(t):
    t = np.asarray(t, np.float64)
    return np.where(t >= 1e31, 1e31, t)


def test_sphere_ts():
    jscene, scene = _canonical()
    o, d = _rays(targets=np.asarray(jscene.spheres.center))
    want = jax_sphere.sphere_ts(jnp.asarray(o), jnp.asarray(d), jscene.spheres.center,
                                jscene.spheres.radius, T_MIN, T_MAX)
    got = sphere.sphere_ts(torch.from_numpy(o), torch.from_numpy(d), scene.spheres.center,
                           scene.spheres.radius, T_MIN, T_MAX)
    assert (np.asarray(want) < 1e31).sum() > 50  # the rays do hit spheres
    np.testing.assert_array_equal(np.asarray(got) < 1e31, np.asarray(want) < 1e31)
    close(_mask_inf(got), _mask_inf(want))


def test_plane_ts():
    jscene, scene = _canonical()
    o, d = _rays(seed=1)
    want = jax_plane.plane_ts(jnp.asarray(o), jnp.asarray(d), jscene.planes, T_MIN, T_MAX)
    got = plane.plane_ts(torch.from_numpy(o), torch.from_numpy(d), scene.planes, T_MIN, T_MAX)
    hits_w, hits_g = np.asarray(want) < 1e31, np.asarray(got) < 1e31
    assert hits_w.sum() > 50
    assert (hits_w != hits_g).mean() < 1e-3  # razor-edge interior tests may flip
    both = hits_w & hits_g
    close(np.asarray(got)[both], np.asarray(want)[both])


def test_sphere_uv():
    n = np.random.default_rng(2).normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:4] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1]]  # poles and seams
    wu, wv = jax_sphere.sphere_uv(jnp.asarray(n))
    gu, gv = sphere.sphere_uv(torch.from_numpy(n))
    close(gu, wu)
    close(gv, wv)


def test_hit_scene_brute_matches_joined_hit():
    jscene, scene = _canonical()
    o, d = _rays(2048, seed=3)
    want = jax_integrator._joined_hit(jscene, jnp.asarray(o), jnp.asarray(d), "brute")
    got = hit.hit_scene_brute(scene, torch.from_numpy(o), torch.from_numpy(d))
    h = np.asarray(want.hit)
    assert h.mean() > 0.2
    assert (np.asarray(got.hit) != h).mean() < 1e-3
    both = h & np.asarray(got.hit)
    for name in ("t", "point", "normal", "u", "v", "albedo", "emit", "fuzz", "ir", "absorption"):
        close(np.asarray(getattr(got, name))[both], np.asarray(getattr(want, name))[both],
              atol=1e-5)
    for name in ("front_face", "mtype", "tex_id"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name))[both],
                                      np.asarray(getattr(want, name))[both])


def _scatter_inputs(n=4096, seed=4):
    g = np.random.default_rng(seed)
    normal = g.normal(size=(n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    ray_dir = g.normal(size=(n, 3)).astype(np.float32) * 3
    return dict(
        ray_origin=g.uniform(-5, 5, size=(n, 3)).astype(np.float32),
        ray_dir=ray_dir,
        point=g.uniform(-5, 5, size=(n, 3)).astype(np.float32),
        normal=normal,
        front_face=g.random(n) < 0.5,
        mtype=g.integers(0, 4, size=n).astype(np.int32),
        fuzz=g.uniform(0, 1, size=n).astype(np.float32),
        ir=g.uniform(1.0, 2.0, size=n).astype(np.float32),
        absorption=g.uniform(0, 0.5, size=(n, 3)).astype(np.float32),
        albedo=g.uniform(0, 1, size=(n, 3)).astype(np.float32),
        seed=g.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32),
    )


def test_scatter():
    inp = _scatter_inputs()
    want = jax_scatter.scatter(**{k: jnp.asarray(v) for k, v in inp.items()})
    t_inp = {k: torch.from_numpy(v.astype(np.int64) if k == "seed" else v) for k, v in inp.items()}
    got = scatter.scatter(**t_inp)
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32), np.asarray(want[0]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    for g, w in zip(got[1:4], want[1:4]):
        close(g, w)


@pytest.mark.parametrize("shape", [(8, 8), (300, 520)], ids=["small", "over256"])
def test_sample_bilinear(shape):
    g = np.random.default_rng(5)
    tex = g.uniform(0.1, 1.0, size=(1,) + shape + (3,)).astype(np.float32)
    u = g.uniform(-2, 3, size=8192).astype(np.float32)
    v = g.uniform(-2, 3, size=8192).astype(np.float32)
    u[:4], v[:4] = [0.0, 1.0, 0.5, -1e-9], [0.0, 1.0, 1e-9, 0.25]  # wrap edges
    tid = np.zeros(8192, np.int32)
    want = jax_texture.sample_bilinear(jnp.asarray(tex), jnp.asarray(tid), jnp.asarray(u),
                                       jnp.asarray(v))
    got = texture.sample_bilinear(torch.from_numpy(tex), torch.from_numpy(tid),
                                  torch.from_numpy(u), torch.from_numpy(v))
    close(got, want)


@pytest.mark.parametrize("frame", [0, 7, 33])
def test_camera_at(frame):
    params = config.read_scene_params(io.StringIO(config.default_config_text()))
    jparams = jax_config.read_scene_params(io.StringIO(jax_config.default_config_text()))
    want = jax_camera.camera_at(jparams.camera_path, frame, jparams.num_frames, 1080, 720,
                                jparams.fov_degrees, background=(0.1, 0.2, 0.3))
    got = camera.camera_at(params.camera_path, frame, params.num_frames, 1080, 720,
                           params.fov_degrees, background=(0.1, 0.2, 0.3), device="cpu")
    for name in want._fields:
        close(getattr(got, name), getattr(want, name), atol=1e-5)


def test_get_rays():
    cam_j = jax_camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 64, 48, 55.0)
    cam = camera.camera_from_numpy({k: np.asarray(v) for k, v in cam_j._asdict().items()}, "cpu")
    g = np.random.default_rng(6)
    i = g.integers(0, 64, size=1024).astype(np.uint32)
    j = g.integers(0, 48, size=1024).astype(np.uint32)
    seed = g.integers(0, 2**32, size=1024, dtype=np.uint64).astype(np.uint32)
    want = jax_camera.get_rays(cam_j, jnp.asarray(i), jnp.asarray(j), jnp.asarray(seed))
    got = camera.get_rays(cam, torch.from_numpy(i.astype(np.int64)),
                          torch.from_numpy(j.astype(np.int64)),
                          torch.from_numpy(seed.astype(np.int64)))
    np.testing.assert_array_equal(got[0].numpy().astype(np.uint32), np.asarray(want[0]))
    close(got[1], want[1])
    close(got[2], want[2])
