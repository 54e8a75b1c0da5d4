"""The CUDA kernels against their plain PyTorch versions, on a CUDA device:
the forward megakernel, its cluster-culled and record modes, the backward
kernel and the texture-gradient scatter, and fit on the card.

Every test here needs a card: each carries the `cuda` marker and skips
without one. The file imports neither jax nor tracer, so it also runs on a
machine without JAX, where the repository's conftest.py (which imports jax)
must be left out:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: a pixel agrees when its max channel |diff| < 1e-3 (FMA
contraction and reassociation flip razor-edge decisions, after which a
sample takes another valid path); >= 99% of pixels must agree and the frame
means must agree to a relative 1e-3.
"""

import io
import os
import sys

import numpy as np
import pytest
import torch

from tracer_torch.kernels import bwd, megakernel, replay, tex_scatter
from tracer_torch.render import camera, renderer
from tracer_torch.scene import builders, config

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_scenes import SKY, big_scene, full_scene  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _agree(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    assert torch.isfinite(got).all()
    diff = (got - want).abs().amax(dim=-1)
    assert (diff < 1e-3).double().mean() >= 0.99, f"max {diff.max()}"
    np.testing.assert_allclose(got.mean().item(), want.mean().item(), rtol=1e-3)


@pytest.mark.parametrize("rr_start", [None, 3])
@pytest.mark.parametrize("quirk", [True, False])
def test_kernel_matches_plain(dev, quirk, rr_start):
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 64, 48, 55.0,
                                   background=SKY, device=dev)
    before = megakernel.LAUNCHES
    got = megakernel.render_frame_kernel(scene, cam, 64, 48, 4, 8, reference_quirk=quirk,
                                         rr_start=rr_start)
    assert megakernel.LAUNCHES == before + 1
    want = renderer.render_frame(scene, cam, 64, 48, 4, 8, reference_quirk=quirk,
                                 rr_start=rr_start)
    _agree(got, want)


def test_kernel_sample_chunks_add_up(dev):
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 40, 30, 55.0,
                                   background=SKY, device=dev)
    one = megakernel.render_frame_kernel(scene, cam, 40, 30, 6, 6)
    two = (megakernel.render_frame_kernel(scene, cam, 40, 30, 2, 6)
           + megakernel.render_frame_kernel(scene, cam, 40, 30, 4, 6, sample_start=2))
    torch.testing.assert_close(two, one, rtol=1e-5, atol=1e-5)


def test_kernel_rejects_what_it_does_not_take(dev):
    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    scene = builders.create_scene(params, texture_loader=lambda _p: None, device=dev)
    cam = camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 8, 8, 90.0, device=dev)
    two_layers = scene._replace(textures=torch.zeros((2, 4, 4, 3), device=dev))
    with pytest.raises(ValueError, match="one texture layer"):
        megakernel.render_frame_kernel(two_layers, cam, 8, 8, 1, 2)
    cpu_cam = camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 8, 8, 90.0,
                                       device="cpu")
    with pytest.raises(ValueError, match="is on cpu"):
        megakernel.render_frame_kernel(scene, cpu_cam, 8, 8, 1, 2)
    with pytest.raises(ValueError, match="spp must be a positive int"):
        megakernel.render_frame_kernel(scene, cam, 8, 8, 0, 2)


# ---- the cluster-culled kernel ----------------------------------------------

def _clustered_case(name, dev):
    if name == "big300":
        return big_scene(300, dev), camera.build_camera_data(
            [0, -30, 6], [0, 0, 2], 64, 48, 50.0, background=SKY, device=dev)
    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    return (builders.create_scene(params, texture_loader=lambda _p: None, device=dev),
            camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 64, 48, 90.0,
                                     background=SKY, device=dev))


@pytest.mark.parametrize("name, rr_start", [("smoke", None), ("big300", None), ("big300", 3)])
def test_clustered_kernel_matches_plain(dev, name, rr_start):
    scene, cam = _clustered_case(name, dev)
    before = (megakernel.LAUNCHES, megakernel.LAUNCHES_CLUSTERED)
    got = megakernel.render_frame_kernel(scene, cam, 64, 48, 4, 8, rr_start=rr_start,
                                         cluster_k=16)
    assert (megakernel.LAUNCHES, megakernel.LAUNCHES_CLUSTERED) == (before[0], before[1] + 1)
    want = renderer.render_frame(scene, cam, 64, 48, 4, 8, rr_start=rr_start, cluster_k=16)
    _agree(got, want)


def test_clustered_kernel_sample_chunks_add_up(dev):
    scene, cam = _clustered_case("big300", dev)
    one = megakernel.render_frame_kernel(scene, cam, 64, 48, 6, 6, cluster_k=16)
    two = (megakernel.render_frame_kernel(scene, cam, 64, 48, 2, 6, cluster_k=16)
           + megakernel.render_frame_kernel(scene, cam, 64, 48, 4, 6, sample_start=2,
                                            cluster_k=16))
    torch.testing.assert_close(two, one, rtol=1e-5, atol=1e-5)


def test_cluster_work_counts_the_plain_visits(dev):
    """At depth 1 every query is a primary ray: the kernel's counts equal
    the plain version's visited clusters and their primitives."""
    from tracer_torch.core import rng
    from tracer_torch.kernels import cluster
    from tracer_torch.render import hit

    scene, cam = _clustered_case("big300", dev)
    queries, visits, tests = megakernel.cluster_work(scene, cam, 64, 48, 1, 1, 16)
    i, j, seeds = renderer.pixel_grid(64, 48, device=dev)
    _, o, d = camera.get_rays(cam, i, j, rng.sample_seed(seeds, 0))
    tables = cluster.pack_clustered(scene, 16)
    vis = hit.cluster_visibility(tables, o, d)
    filled = (tables.slots.reshape(tables.num_clusters, -1) >= 0).sum(dim=1)
    assert (queries, visits, tests) == (64 * 48, int(vis.sum()), int((vis * filled).sum()))


def test_counted_instantiation_renders_the_same_frame(dev):
    scene, cam = _clustered_case("big300", dev)
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    counted = megakernel._render_clustered(scene, cam, 64, 48, 2, 4, True, 3, 0, 16, counts)
    plain = megakernel.render_frame_kernel(scene, cam, 64, 48, 2, 4, rr_start=3, cluster_k=16)
    assert torch.equal(counted, plain) and int(counts[0]) >= 64 * 48 * 2


@pytest.mark.parametrize("bad", [-1, 2.0, True, "16"])
def test_clustered_kernel_rejects_bad_cluster_k(dev, bad):
    scene, cam = _clustered_case("smoke", dev)
    with pytest.raises(ValueError, match="cluster_k must be an int >= 0"):
        megakernel.render_frame_kernel(scene, cam, 64, 48, 1, 2, cluster_k=bad)


# ---- the gradient path ---------------------------------------------------

def test_record_kernel_matches_plain_record(dev):
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 64, 48, 55.0,
                                   background=SKY, device=dev)
    before = megakernel.LAUNCHES_RECORD
    got = megakernel.render_frame_kernel_record(scene, cam, 64, 48, 4, 8, rr_start=3,
                                                tape_fields=13)
    assert megakernel.LAUNCHES_RECORD == before + 1
    want = renderer.render_frame_record(scene, cam, 64, 48, 4, 8, rr_start=3, tape_fields=13)
    _agree(got[0], want[0])
    same = got[1] == want[1]
    assert same.double().mean() >= 0.99
    gt, wt = got[2][same], want[2][same]
    scale = wt.abs().amax(dim=0).clamp_min(1.0)
    assert ((gt - wt).abs() <= 1e-3 * scale).all(dim=1).double().mean() >= 0.99


@pytest.mark.parametrize("textured", [False, True], ids=["smoke", "textured-rr"])
def test_backward_kernel_matches_plain_replay(dev, textured):
    """Both fed the same kernel-recorded tape; leaves within 1e-4 of their
    max|g| (atomics add in no fixed order; the kernel's cbrtf and the plain
    version's float64 cube root may differ in the last bit)."""
    if textured:
        scene, rr = full_scene(dev), 3
        cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 40, 30, 55.0,
                                       background=SKY, device=dev)
    else:
        params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
        scene, rr = builders.create_scene(params, texture_loader=lambda _p: None, device=dev), None
        cam = camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 40, 30, 90.0,
                                       background=SKY, device=dev)
    out = megakernel.render_frame_kernel_record(scene, cam, 40, 30, 2, 6, rr_start=rr,
                                                tape_fields=13)
    table, camv = bwd.pack_tables(scene, cam)
    idx2 = out[1].reshape(12, -1)
    g2 = torch.randn((1200, 3), generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    t2 = bwd._field_major(out[2], 2, 6, 1200) if textured else None
    kw = dict(rr_start=rr, t2=t2, want_texgrad=textured)
    before = bwd.LAUNCHES
    got = bwd.bwd_kernel(table, camv, idx2, g2, 40, 2, 6, **kw)
    assert bwd.LAUNCHES == before + 1
    want = replay.replay_cotangents(table, camv, idx2, g2, 40, 2, 6, **kw)
    for (name, a), (_, b) in zip(bwd.leaf_grads(scene, cam, got[0], got[1]),
                                 bwd.leaf_grads(scene, cam, want[0], want[1])):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    torch.testing.assert_close(got[2], out[0].reshape(-1, 3), rtol=0,
                               atol=1e-4 * float(out[0].abs().max()))
    if textured:
        torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-4 * float(want[3].abs().max()))


def test_tex_scatter_kernel_matches_plain(dev):
    rng = np.random.default_rng(0)
    spp, depth, p, th, tw = 2, 3, 1000, 40, 200
    r = spp * depth
    g = torch.tensor(rng.normal(size=(3 * r, p)).astype(np.float32), device=dev)
    t2 = torch.ones((13 * r, p), device=dev)
    t2[9 * r:10 * r] = torch.tensor(rng.integers(0, tw, (r, p)), device=dev).float()
    t2[10 * r:11 * r] = torch.tensor(rng.integers(0, th, (r, p)), device=dev).float()
    t2[11 * r:13 * r] = torch.tensor(rng.random((2 * r, p)).astype(np.float32), device=dev)
    before = tex_scatter.LAUNCHES
    got = tex_scatter.texture_image_grads_kernel(g, t2, spp, depth, th, tw)
    assert tex_scatter.LAUNCHES == before + 1
    want = bwd.texture_image_grads(g, t2, spp, depth, th, tw)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_fit_on_the_card_lowers_the_loss(dev):
    from tracer_torch.opt import fit

    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 48, 32, 55.0,
                                   background=SKY, device=dev)
    true = scene._replace(materials=scene.materials._replace(
        albedo=scene.materials.albedo * 0.8))
    target = megakernel.render_frame_kernel(true, cam, 48, 32, 4, 6) / 4
    before = (megakernel.LAUNCHES_RECORD, bwd.LAUNCHES)
    _, losses = fit.fit(scene, cam, target, 48, 32, spp=4, max_depth=6,
                        param_paths=("materials.albedo", "spheres.center"), steps=4,
                        learning_rate=2e-2, log_every=0, engine="cuda")
    assert (megakernel.LAUNCHES_RECORD, bwd.LAUNCHES) == (before[0] + 4, before[1] + 4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_record_raises_when_the_tapes_do_not_fit(dev):
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 4096, 4096, 55.0,
                                   device=dev)
    with pytest.raises(RuntimeError, match="record tapes need"):
        megakernel.render_frame_kernel_record(scene, cam, 4096, 4096, 1024, 50)


def test_backward_kernel_global_atomics_and_band_arguments(dev, monkeypatch):
    """The global-atomic dtable variant (taken above SHARED_BYTES_MAX) and
    the band arguments (row_offset, sample_start) against the plain replay."""
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 40, 30, 55.0,
                                   background=SKY, device=dev)
    out = megakernel.render_frame_kernel_record(scene, cam, 40, 20, 2, 5, tape_fields=9)
    table, camv = bwd.pack_tables(scene, cam)
    idx2 = out[1].reshape(10, -1)
    t2 = bwd._field_major(out[2], 2, 5, 800)
    g2 = torch.randn((800, 3), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    kw = dict(t2=t2, row_offset=10, sample_start=2)
    monkeypatch.setattr(bwd, "SHARED_BYTES_MAX", 0)
    got = bwd.bwd_kernel(table, camv, idx2, g2, 40, 2, 5, **kw)
    want = replay.replay_cotangents(table, camv, idx2, g2, 40, 2, 5, **kw)
    for (name, a), (_, b) in zip(bwd.leaf_grads(scene, cam, got[0], got[1]),
                                 bwd.leaf_grads(scene, cam, want[0], want[1])):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4 * float(want[2].abs().max()))
