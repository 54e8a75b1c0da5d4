"""Stratified sampling in tracer_torch against tracer, on the CPU: the primary
rays (`camera.get_rays` with a sample index and a grid), the plain
renderer with `stratify` and with an explicit grid and `sample_start`, the
plain record and replay with the grid against tracer's Pallas record and
backward (interpret mode, once per module), and the frame driver's
chunked, non-square, stratified frame against tracer's one-dispatch
stratified frame.

Tolerances: rays rtol 1e-6, atol 1e-6 (the same float32 operations in
both packages); frames by tests/test_torch_render.py's rule (a pixel agrees
when its max channel |diff| < 1e-3, >= 99% must agree, frame means to a
relative 1e-3); gradients by tests/test_grad.py:_cmp (every float leaf
within 1e-5 * max(1, max|ref|) absolute and 1e-4 relative); index tapes
equal.
"""

import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer.core import rng as jax_rng
from tracer.pallas import bwd as jax_bwd
from tracer.pallas import megakernel as jax_megakernel
from tracer.render import camera as jax_camera
from tracer.render import renderer as jax_renderer
from tracer.scene import builders as jax_builders
from tracer.scene import config as jax_config
from tracer_torch import cli
from tracer_torch.core import rng
from tracer_torch.kernels import bwd, replay
from tracer_torch.render import camera, driver, renderer
from tracer_torch.scene import builders, config
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(__file__))
from test_grad import H, W, _cam, _scene  # noqa: E402
from test_torch_driver import TSV, _small_config  # noqa: E402
from test_torch_render import assert_frames_agree  # noqa: E402
from test_torch_scene import jax_cam_fields, jax_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401

# a square spp: tracer's scene_cam_grads(stratify=True) takes k = sqrt(spp); depth 2 (the
# primary hit and one bounce) keeps the interpret-mode reference's compile short
SPP, DEPTH = 4, 2
G_FB = np.random.default_rng(2).normal(size=(H, W, 3)).astype(np.float32)


def _smoke_pair(w, h):
    text = config.smoke_config_text()
    jscene = jax_builders.create_scene(jax_config.read_scene_params(io.StringIO(text)),
                                       texture_loader=lambda _p: None)
    jcam = jax_camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], w, h, 90.0,
                                        background=(0.05, 0.07, 0.1))
    return (jscene, jcam, T.scene_from_numpy(jax_scene_fields(jscene), "cpu"),
            camera.camera_from_numpy(jax_cam_fields(jcam), "cpu"))


@pytest.mark.parametrize("s, k", [(0, 2), (5, 2), (7, 3), (2**24 + 3, 4)])
def test_get_rays_stratified_matches_tracer(s, k):
    _, jcam, _, cam = _smoke_pair(16, 8)
    g = np.random.default_rng(s % 97)
    i = g.integers(0, 16, 64).astype(np.uint32)
    j = g.integers(0, 8, 64).astype(np.uint32)
    seed = g.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)
    want = jax_camera.get_rays(jcam, jnp.asarray(i), jnp.asarray(j), jnp.asarray(seed),
                               sample_index=jnp.uint32(s), sqrt_spp=k)
    got = camera.get_rays(cam, torch.tensor(i.astype(np.int64)), torch.tensor(j.astype(np.int64)),
                          torch.tensor(seed.astype(np.int64)), sample_index=s, sqrt_spp=k)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    plain = camera.get_rays(cam, torch.tensor(i.astype(np.int64)), torch.tensor(j.astype(np.int64)),
                            torch.tensor(seed.astype(np.int64)))
    assert not torch.equal(plain[2], got[2])  # the grid moves the jitter


@pytest.mark.parametrize("quirk", [True, False])
def test_render_frame_stratified_matches_xla(quirk):
    jscene, jcam, scene, cam = _smoke_pair(32, 8)
    want = jax_renderer.render_frame(jscene, jcam, 32, 8, spp=4, max_depth=4, stratify=True,
                                     reference_quirk=quirk, chunk=256)
    got = renderer.render_frame(scene, cam, 32, 8, 4, 4, stratify=True, reference_quirk=quirk)
    assert_frames_agree(got, want)
    assert not torch.equal(got, renderer.render_frame(scene, cam, 32, 8, 4, 4,
                                                      reference_quirk=quirk))


def test_strat_sqrt_spp_with_sample_start_matches_xla():
    """A chunk of a larger frame: 5 samples from sample 2 on a 3x3 grid."""
    jscene, jcam, scene, cam = _smoke_pair(16, 8)
    ji, jj, jseed = jax_renderer.pixel_grid(16, 8)
    want = jax_renderer.render_pixels(jscene, jcam, ji, jj, jseed, 5, 4, stratify=True,
                                      strat_sqrt_spp=3, sample_start=2, chunk=128)
    i, j, seed = renderer.pixel_grid(16, 8, device="cpu")
    np.testing.assert_array_equal(seed.numpy(), np.asarray(jseed).astype(np.int64))
    got = renderer.render_pixels(scene, cam, i, j, seed, 5, 4, stratify=True, strat_sqrt_spp=3,
                                 sample_start=2)
    assert_frames_agree(got.reshape(8, 16, 3), np.asarray(want).reshape(8, 16, 3))


def test_stratify_needs_a_square_spp_or_a_grid():
    _, _, scene, cam = _smoke_pair(4, 4)
    with pytest.raises(ValueError, match="square spp"):
        renderer.render_frame(scene, cam, 4, 4, 3, 2, stratify=True)
    assert camera.strat_grid(True, 3, 2) == 2 and camera.strat_grid(False, 3) == 0
    with pytest.raises(ValueError, match="strat_sqrt_spp"):
        camera.strat_grid(True, 4, -1)


@pytest.fixture(scope="module")
def ref():
    """tracer's recording kernel and backward kernel with stratify (interpret
    mode, once): tests/test_grad.py's tie-free scene, untextured, spp 4."""
    jscene = _scene()
    rec = jax_megakernel.render_frame_pallas_record(jscene, _cam(), W, H, SPP, DEPTH,
                                                    interpret=True, stratify=True)
    gs, gc, fb2 = jax_bwd.scene_cam_grads(jscene, _cam(), rec[1], jnp.asarray(G_FB), W, H,
                                          SPP, DEPTH, stratify=True, interpret=True)
    return dict(scene=jscene, fb=np.asarray(rec[0]), idx=np.asarray(rec[1]), g_scene=gs,
                g_cam=gc, fb2=np.asarray(fb2))


def _port_pair():
    return (T.scene_from_numpy(jax_scene_fields(_scene()), "cpu"),
            camera.camera_from_numpy(jax_cam_fields(_cam()), "cpu"))


def _cmp(got, want, atol_scale=1e-5):
    """tests/test_grad.py:_cmp on one leaf."""
    want = np.asarray(want)
    tol = atol_scale * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=1e-4)


def test_stratified_record_matches_pallas_record(ref):
    scene, cam = _port_pair()
    fb, idx = renderer.render_frame_record(scene, cam, W, H, SPP, DEPTH, stratify=True)
    np.testing.assert_array_equal(idx.numpy(), ref["idx"])
    np.testing.assert_allclose(fb.numpy(), ref["fb"], atol=1e-4, rtol=1e-4)
    _, idx0 = renderer.render_frame_record(scene, cam, W, H, SPP, DEPTH)
    assert not torch.equal(idx0, idx)  # stratification moves the paths


def test_stratified_replay_matches_pallas_backward(ref):
    scene, cam = _port_pair()
    idx = torch.tensor(ref["idx"])
    g_scene, g_cam, fb2 = bwd.scene_cam_grads(scene, cam, idx, torch.tensor(G_FB), W, H, SPP,
                                              DEPTH, stratify=True)
    np.testing.assert_allclose(fb2.numpy(), ref["fb2"], atol=1e-5)
    for group in ("spheres", "planes", "materials"):
        for name, leaf in getattr(g_scene, group)._asdict().items():
            want = getattr(getattr(ref["g_scene"], group), name)
            if leaf is not None:
                _cmp(leaf, want)
    for name, leaf in g_cam._asdict().items():
        _cmp(leaf, getattr(ref["g_cam"], name))
    # without the grid the replay regenerates other primary rays
    table, camv = bwd.pack_tables(scene, cam)
    other = replay.replay_cotangents(table, camv, idx.reshape(SPP * DEPTH, -1),
                                     torch.tensor(G_FB).reshape(-1, 3), W, SPP, DEPTH)
    assert not np.allclose(other[2].numpy(), ref["fb2"].reshape(-1, 3), atol=1e-5)


def test_chunked_stratified_animation_matches_one_dispatch(tmp_path):
    """The driver's chunks take the whole frame's grid: chunks of 3 and 1
    samples (not square) give tracer's one-dispatch stratified frame (its
    own driver took the grid from each chunk's spp)."""
    params = config.read_scene_params(_small_config(tmp_path).read_text())
    jparams = jax_config.read_scene_params(_small_config(tmp_path).read_text())
    scene = builders.create_scene(params, device="cpu")
    jscene = jax_builders.create_scene(jparams)
    jcam = jax_camera.camera_at(jparams.camera_path, 0, jparams.num_frames, jparams.width,
                                jparams.height, jparams.fov_degrees)
    spp = params.render.sqrt_rays_per_pixel ** 2
    want = jax_renderer.render_frame(jscene, jcam, params.width, params.height, spp=spp,
                                     max_depth=params.render.max_depth, stratify=True,
                                     chunk=512)
    out = io.StringIO()
    got = driver.render_animation(scene, params, engine="torch", out=out, spp_chunk=3,
                                  stratify=True)
    assert spp == 4 and len(out.getvalue().splitlines()) == 1
    assert_frames_agree(got, want)
    uniform = driver.render_animation(scene, params, engine="torch", out=io.StringIO(),
                                      spp_chunk=3)
    assert not np.array_equal(got, uniform)


def test_cli_stratify_renders(tmp_path, capsys):
    cfg = _small_config(tmp_path)
    assert cli.main(["--cpu", "--config", str(cfg), "--stratify"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and TSV.match(lines[0]).group(1) == "0"
    from tracer_torch.io import image as image_io

    assert image_io.read_binary(str(tmp_path / "out_0.bin")).any()


def test_sample_seed_and_rng_unchanged_by_stratify():
    """The grid uses the same two draws: the seed after ray generation is the
    uniform jitter's, so the rest of the stream is unchanged."""
    seed = torch.tensor([1, 2**31 + 5, 77], dtype=torch.int64)
    _, _, _, cam = _smoke_pair(4, 4)
    i = torch.tensor([0, 1, 3])
    s0 = camera.get_rays(cam, i, i, rng.sample_seed(seed, 3))[0]
    s1 = camera.get_rays(cam, i, i, rng.sample_seed(seed, 3), sample_index=3, sqrt_spp=2)[0]
    assert torch.equal(s0, s1)
    want = jax_rng.sample_seed(jnp.asarray(seed.numpy().astype(np.uint32)), 3)
    np.testing.assert_array_equal(rng.sample_seed(seed, 3).numpy(),
                                  np.asarray(want).astype(np.int64))
