"""The plain PyTorch renderer (the CUDA kernel's twin) against tracer: the
golden fixture, the XLA renderer, and the Pallas megakernel in interpret
mode, on the same scene, camera and seeds.

Tolerances: the golden fixture at tests/test_golden.py's rtol=1e-4,
atol=1e-5; against the other engines a pixel agrees when its max channel
|diff| < 1e-3 (float32 reassociation can flip a razor-edge decision, after
which the sample takes another valid path) and >= 99% of pixels must agree,
with frame means equal to a relative 1e-3 (tests/test_pallas.py's bar).
"""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.core import rng as jax_rng
from tracer.pallas import megakernel as jax_megakernel
from tracer.render import camera as jax_camera
from tracer.render import renderer as jax_renderer
from tracer.scene import builders as jax_builders
from tracer.scene import config as jax_config
from tracer.scene import types as jax_T
from tracer_torch.core import rng
from tracer_torch.kernels import megakernel
from tracer_torch.render import camera, renderer
from tracer_torch.scene import builders, config
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(__file__))
from test_parity import _full_scene  # noqa: E402
from test_torch_scene import jax_cam_fields, jax_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401
from torch_scenes import (SKY, closed_sphere, sky_camera, sky_scene,  # noqa: E402
                          sphere_field_camera, sphere_field_fields)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "canonical_32x24_spp4_d5.npz")


def assert_frames_agree(got, want, frac=0.99):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = np.abs(got - want).max(axis=-1)
    assert (diff < 1e-3).mean() >= frac, f"max {diff.max()}, frac {(diff < 1e-3).mean()}"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-3)


def _smoke(jax_side=False):
    text = config.smoke_config_text()
    if jax_side:
        return jax_builders.create_scene(jax_config.read_scene_params(io.StringIO(text)),
                                         texture_loader=lambda _p: None)
    return builders.create_scene(config.read_scene_params(io.StringIO(text)),
                                 texture_loader=lambda _p: None, device="cpu")


def _both(jscene, jcam):
    """The JAX scene and camera carried across to the port."""
    return (T.scene_from_numpy(jax_scene_fields(jscene), "cpu"),
            camera.camera_from_numpy(jax_cam_fields(jcam), "cpu"))


def _jcam(w, h, background=(0.0, 0.0, 0.0)):
    return jax_camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], w, h, 90.0,
                                        background=background)


def test_reproduces_golden_fixture():
    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    scene = _smoke()
    lookfrom, lookat = camera.camera_path_position(params.camera_path, 0, params.num_frames,
                                                   device="cpu")
    cam = camera.build_camera_data(lookfrom, lookat, 32, 24, params.fov_degrees, device="cpu")
    fb = renderer.render_frame(scene, cam, 32, 24, spp=4, max_depth=5)
    assert fb.shape == (24, 32, 3) and fb.dtype == torch.float32
    np.testing.assert_allclose(fb.numpy(), np.load(GOLDEN)["fb"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("quirk", [True, False])
def test_matches_xla_renderer(quirk):
    jscene, jcam = _smoke(jax_side=True), _jcam(32, 8, background=(0.05, 0.07, 0.1))
    scene, cam = _both(jscene, jcam)
    want = jax_renderer.render_frame(jscene, jcam, 32, 8, spp=2, max_depth=4,
                                     reference_quirk=quirk, chunk=256)
    got = renderer.render_frame(scene, cam, 32, 8, spp=2, max_depth=4, reference_quirk=quirk)
    assert_frames_agree(got, want)


@pytest.mark.parametrize("textured", [False, True], ids=["untextured", "tex8"])
def test_matches_pallas_interpret(textured):
    jscene, _ = _full_scene(with_texture=textured)
    jcam = jax_camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 32, 8, 55.0,
                                        background=(0.05, 0.07, 0.1))
    scene, cam = _both(jscene, jcam)
    want = jax_megakernel.render_frame_pallas(jscene, jcam, 32, 8, spp=2, max_depth=4,
                                              interpret=True)
    got = renderer.render_frame(scene, cam, 32, 8, spp=2, max_depth=4)
    assert (np.asarray(want).max(axis=-1) > 0).mean() > 0.9  # every path is lit
    assert_frames_agree(got, want)


def test_rr_start_matches_xla_renderer():
    jscene, jcam = _smoke(jax_side=True), _jcam(32, 8, background=(0.05, 0.07, 0.1))
    scene, cam = _both(jscene, jcam)
    want = jax_renderer.render_frame(jscene, jcam, 32, 8, spp=4, max_depth=6, rr_start=3,
                                     chunk=256)
    got = renderer.render_frame(scene, cam, 32, 8, spp=4, max_depth=6, rr_start=3)
    assert_frames_agree(got, want)
    plain = renderer.render_frame(scene, cam, 32, 8, spp=4, max_depth=6)
    assert not torch.equal(got, plain)  # roulette changes the estimator


def test_partial_tile_matches_xla_renderer():
    jscene, jcam = _smoke(jax_side=True), _jcam(20, 5, background=(0.05, 0.07, 0.1))
    scene, cam = _both(jscene, jcam)
    want = jax_renderer.render_frame(jscene, jcam, 20, 5, spp=1, max_depth=3, chunk=128)
    got = renderer.render_frame(scene, cam, 20, 5, spp=1, max_depth=3)
    assert got.shape == (5, 20, 3)
    assert_frames_agree(got, want)


@pytest.mark.parametrize("split", [1, 3])
def test_sample_chunks_add_up_to_one_shot(split):
    scene = _smoke()
    cam = camera.camera_from_numpy(jax_cam_fields(_jcam(24, 16, (0.05, 0.07, 0.1))), "cpu")
    one = renderer.render_frame(scene, cam, 24, 16, spp=4, max_depth=5)
    parts = (renderer.render_frame(scene, cam, 24, 16, spp=split, max_depth=5)
             + renderer.render_frame(scene, cam, 24, 16, spp=4 - split, max_depth=5,
                                     sample_start=split))
    torch.testing.assert_close(parts, one, rtol=1e-5, atol=1e-5)


def test_render_pixels_chunking_is_invisible():
    scene = _smoke()
    cam = camera.camera_from_numpy(jax_cam_fields(_jcam(16, 8, (0.05, 0.07, 0.1))), "cpu")
    i, j, seeds = renderer.pixel_grid(16, 8, device="cpu")
    whole = renderer.render_pixels(scene, cam, i, j, seeds, 2, 4)
    chunked = renderer.render_pixels(scene, cam, i, j, seeds, 2, 4, chunk=37)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_kernel_wrapper_takes_the_plain_version_for_cpu_tensors():
    scene = _smoke()
    cam = camera.camera_from_numpy(jax_cam_fields(_jcam(16, 8, (0.05, 0.07, 0.1))), "cpu")
    before = megakernel.LAUNCHES
    got = megakernel.render_frame_kernel(scene, cam, 16, 8, 2, 4, rr_start=2, sample_start=3)
    want = renderer.render_frame(scene, cam, 16, 8, 2, 4, rr_start=2, sample_start=3)
    assert torch.equal(got, want)
    assert megakernel.LAUNCHES == before  # the plain version is not a launch


def test_total_rays():
    assert renderer.total_rays(1080, 720, 50) == jax_renderer.total_rays(1080, 720, 50)


def test_query_count_is_one_per_sample_when_every_ray_misses():
    assert renderer.query_count(sky_scene("cpu"), sky_camera(16, 12, "cpu"), 16, 12, 3, 8) \
        == 16 * 12 * 3


def test_query_count_is_max_depth_per_sample_inside_a_closed_sphere():
    cam = camera.build_camera_data([0.0, 0.0, 0.0], [1.0, 0.3, 0.2], 10, 8, 70.0,
                                   background=SKY, device="cpu")
    assert renderer.query_count(closed_sphere("cpu"), cam, 10, 8, 2, 4) == 10 * 8 * 2 * 4
    # roulette ends paths early, so the count falls
    assert renderer.query_count(closed_sphere("cpu"), cam, 10, 8, 2, 4, rr_start=0) < 640


def test_sphere_field_pixel_differs_by_xla_fma_contraction():
    """Why the port's brute frame of the 2000-sphere field differs from
    tracer's brute XLA frame on a few pixels (under 1% at 64x32 spp2 d3
    with the field's camera; every other pixel is bit-equal). On pixel
    (row 12, column 33), sample 0, the first value that differs is the
    primary ray's direction: XLA:CPU's jit fuses `pixel_center + offset *
    delta` (tracer.render.camera.get_rays) into one FMA, while JAX run op
    by op rounds the product and the sum apart, as the port does, bit for
    bit. The change in d.y moves the hit point enough that tracer's first
    bounce hits the same sphere again just past T_MIN, where the port's
    bounce leaves it; the paths part there."""
    fields, cols = sphere_field_fields(2000)
    group = lambda cls, pre: cls(*(jnp.asarray(fields[f"{pre}.{n}"]) for n in cls._fields))
    jscene = jax_T.Scene(group(jax_T.Spheres, "spheres"), group(jax_T.Planes, "planes"),
                         group(jax_T.Materials, "materials"), None, None)
    scene = T.scene_from_numpy(fields, "cpu")
    cam = sphere_field_camera(cols, 64, 32, "cpu")
    jcam = jax_camera.CameraData(*(jnp.asarray(x.numpy()) for x in cam))
    lin = 12 * 64 + 33
    ji, jj, jseed = jax_renderer.pixel_grid(64, 32)
    sd = jax_rng.sample_seed(jseed, jnp.uint32(0))
    eager = np.asarray(jax_camera.get_rays(jcam, ji, jj, sd)[2][lin])
    jitted = np.asarray(jax.jit(lambda s: jax_camera.get_rays(jcam, ji, jj, s))(sd)[2][lin])
    i, j, seed = renderer.pixel_grid(64, 32, device="cpu")
    ours = camera.get_rays(cam, i, j, rng.sample_seed(seed, 0))[2][lin].numpy()
    np.testing.assert_array_equal(ours.view(np.int32), eager.view(np.int32))
    ulps = np.abs(jitted.view(np.int32) - eager.view(np.int32))
    assert ulps[0] == ulps[2] == 0 and 1 <= ulps[1] <= 2
    # XLA:CPU's jit contracts a + b * c: one rounding, not two
    g = np.random.default_rng(0)
    a, b, c = (g.normal(size=4096).astype(np.float32) for _ in range(3))
    fused = np.asarray(jax.jit(lambda a, b, c: a + b * c)(a, b, c))
    one_rounding = (a.astype(np.float64) + b.astype(np.float64) * c.astype(np.float64))
    np.testing.assert_array_equal(fused, one_rounding.astype(np.float32))
    assert (fused != a + b * c).mean() > 0.1
    # the frames: that pixel differs, nearly every other one is bit-equal
    want = np.asarray(jax_renderer.render_frame(jscene, jcam, 64, 32, spp=2, max_depth=3,
                                                intersector="brute", chunk=64 * 32))
    got = renderer.render_frame(scene, cam, 64, 32, 2, 3).numpy()
    differ = (got != want).any(axis=-1)
    assert differ[12, 33] and differ.mean() < 0.01
