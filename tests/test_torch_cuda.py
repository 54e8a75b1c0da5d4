"""The CUDA kernels against their plain PyTorch versions, on a CUDA device:
the forward megakernel, its cluster-culled, BVH, record and reference-stream
modes (each with and without stratified jitter, and on row bands), the brute
kernels' object cull against every primitive, the backward kernel
and the texture-gradient scatter, fit on the card, and the sharded kernel
paths of tracer_torch.dist on one NCCL rank.

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

import dataclasses
import datetime
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tracer_torch.bvh import builder as bvh_builder
from tracer_torch.dist import sharding
from tracer_torch.kernels import bwd, diff, megakernel, nvcc, pack, replay, tex_scatter
from tracer_torch.render import camera, renderer
from tracer_torch.scene import builders, config
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_scenes import one_torch_thread  # noqa: E402,F401
from torch_scenes import sphere_field  # noqa: E402
from torch_scenes import (EXHAUSTED_SEEDS, SKY, big_scene, closed_box,  # noqa: E402
                          exhausted_lane_view, full_scene, sample_start_reaching, sky_camera,
                          sky_scene)

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
    """At depth 1 every query is a primary ray: the kernel's leaves reached
    and primitive tests are at most the plain version's visible clusters
    and their primitives, and equal those of tests/cluster_walk.py's
    emulation of the walk."""
    from tracer_torch.core import rng
    from tracer_torch.kernels import cluster
    from tracer_torch.render import hit

    scene, cam = _clustered_case("big300", dev)
    work = megakernel.loop_work(scene, cam, 64, 48, 1, 1, cluster_k=16)
    i, j, seeds = renderer.pixel_grid(64, 48, device=dev)
    _, o, d = camera.get_rays(cam, i, j, rng.sample_seed(seeds, 0))
    tables = cluster.pack_clustered(scene, 16)
    vis = hit.cluster_visibility(tables, o, d)
    filled = (tables.slots.reshape(tables.num_clusters, -1) >= 0).sum(dim=1)
    assert work.queries == 64 * 48
    assert work.visits <= int(vis.sum()) and work.tests <= int((vis * filled).sum())
    _, _, _, leaves, tests = _walk(scene, tables, o, d)
    assert (work.visits, work.tests) == (leaves.sum(), tests.sum())


def _walk(scene, tables, o, d):
    """tests/cluster_walk.py's walk of these rays, over the plain roots."""
    from cluster_walk import walk

    from tracer_torch.core import T_MAX, T_MIN
    from tracer_torch.render import hit

    t_all = hit._all_ts(scene, o, d, T_MIN, T_MAX)
    return walk(tables.nodes.cpu().numpy(), tables.slots.cpu().numpy(), tables.k,
                o.cpu().numpy(), d.cpu().numpy(), t_all.cpu().numpy())


def test_node_tests_count_the_walk(dev):
    """The counted instantiation's node tests on big300's primary rays equal
    the emulated walk's, and stay below the cluster count per query."""
    from tracer_torch.core import rng
    from tracer_torch.kernels import cluster

    scene, cam = _clustered_case("big300", dev)
    work = megakernel.loop_work(scene, cam, 64, 48, 1, 1, cluster_k=16)
    i, j, seeds = renderer.pixel_grid(64, 48, device=dev)
    _, o, d = camera.get_rays(cam, i, j, rng.sample_seed(seeds, 0))
    tables = cluster.pack_clustered(scene, 16)
    _, _, node_tests, _, _ = _walk(scene, tables, o, d)
    assert work.node_tests == node_tests.sum()
    assert work.node_tests < tables.num_clusters * work.queries


def test_counted_instantiation_renders_the_same_frame(dev):
    scene, cam = _clustered_case("big300", dev)
    counts = torch.zeros(len(megakernel.COUNT_NAMES), dtype=torch.int64, device=dev)
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
    _agree_record(got, want)


def _agree_record(got, want):
    """The frame by _agree, >= 99% of index-tape slots equal and, on >= 99%
    of those, every texture field within 1e-3 of its scale."""
    _agree(got[0], want[0])
    assert len(got) == len(want)
    same = got[1] == want[1]
    assert same.double().mean() >= 0.99
    if len(want) == 3:
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


# ---- the regenerating bounce loop, its tables and its counts ------------------

def _closed_camera(dev, w=32, h=24):
    return camera.build_camera_data([0.0, 0.0, 0.0], [1.0, 0.3, 0.2], w, h, 70.0,
                                    background=SKY, device=dev)


@pytest.mark.parametrize("record", [False, True], ids=["K1", "K1-rec"])
@pytest.mark.parametrize("name, spp, depth, rr_start", [
    ("spp1", 1, 8, None), ("odd-spp", 5, 8, None), ("max-depth", 3, 6, None),
    ("rr_start", 4, 10, 2)])
def test_regenerating_loop_matches_plain(dev, name, spp, depth, rr_start, record):
    """Lanes start their next sample as soon as a path ends: one sample,
    an odd count, paths that reach max_depth (inside a closed box) and
    roulette, against the plain version."""
    if name == "max-depth":
        scene, cam = closed_box(dev), _closed_camera(dev)
    else:
        scene = full_scene(dev)
        cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 32, 24, 55.0,
                                       background=SKY, device=dev)
    kw = dict(rr_start=rr_start)
    if record:
        got = megakernel.render_frame_kernel_record(scene, cam, 32, 24, spp, depth,
                                                    tape_fields=13, **kw)
        _agree_record(got, renderer.render_frame_record(scene, cam, 32, 24, spp, depth,
                                                        tape_fields=13, **kw))
    else:
        got = megakernel.render_frame_kernel(scene, cam, 32, 24, spp, depth, **kw)
        _agree(got, renderer.render_frame(scene, cam, 32, 24, spp, depth, **kw))


def test_shared_and_global_tables_give_the_same_frame(dev, monkeypatch):
    """The records staged in shared memory or read from global memory: the
    same float code, so the same frames and tapes."""
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 40, 30, 55.0,
                                   background=SKY, device=dev)

    def run():
        return (megakernel.render_frame_kernel(scene, cam, 40, 30, 4, 8, rr_start=3),
                *megakernel.render_frame_kernel_record(scene, cam, 40, 30, 2, 6, tape_fields=13),
                megakernel.render_frame_kernel(scene, cam, 40, 30, 4, 8, cluster_k=2))

    shared = run()
    monkeypatch.setattr(megakernel, "TABLE_SHARED_BYTES_MAX", 0)
    for a, b in zip(shared, run()):
        assert torch.equal(a, b)


def _config_txt(dev):
    """config.txt's scene (its three polyhedra noted as groups, a 48x64
    floor texture) and its parameters."""
    params = config.read_scene_params(io.StringIO(config.default_config_text()))
    tex = np.random.default_rng(5).uniform(0.1, 1.0, size=(48, 64, 3)).astype(np.float32)
    scene = builders.create_scene(params, texture_loader=lambda _p: tex, device=dev)
    assert len(scene.groups) == 3
    return scene, params


@pytest.mark.parametrize("frame, w, h, far", [(0, 64, 48, False), (50, 64, 48, False),
                                              (20, 256, 192, False), (0, 128, 96, True)],
                         ids=["frame0", "frame50", "frame20-256x192", "far"])
def test_group_cull_keeps_brute_bit_for_bit(dev, monkeypatch, frame, w, h, far):
    """config.txt with its groups and with groups=None (every primitive
    tested): K1 (with roulette and stratified jitter too), K1-ref, a row
    band, and K1-rec's frame, index tape and 13-field texture tape, bit for
    bit, with the records in shared and in global memory; also from a
    camera ten times as far away with a twentieth of the field of view,
    where the kernel's rounding grows (more of its rays miss)."""
    scene, p = _config_txt(dev)
    path, fov = p.camera_path, p.fov_degrees
    if far:
        path, fov = dataclasses.replace(path, rc0=10 * path.rc0), fov / 20
    cam = camera.camera_at(path, frame, p.num_frames, w, h, fov, device=dev)

    def run(sc):
        return (megakernel.render_frame_kernel(sc, cam, w, h, 4, 50),
                megakernel.render_frame_kernel(sc, cam, w, h, 4, 50, rr_start=3, stratify=True),
                megakernel.render_frame_kernel(sc, cam, w, h, 4, 50, rng_mode="reference"),
                megakernel.render_frame_kernel(sc, cam, w, 20, 4, 50, row_offset=17),
                *megakernel.render_frame_kernel_record(sc, cam, w, h, 2, 50, tape_fields=13))

    culled = run(scene)
    every = run(scene._replace(groups=None))
    monkeypatch.setattr(megakernel, "TABLE_SHARED_BYTES_MAX", 0)  # the records in global memory
    for got in (every, run(scene)):
        for a, b in zip(got, culled):
            assert torch.equal(a, b)
    assert culled[0].sum() > 0 and (culled[5] >= 0).sum() > (w * h // 2 if far else w * h)


def test_group_cull_counts_fewer_tests_and_the_same_queries(dev):
    """The counted K1, K1-rec and brute K1-ref with and without groups: the
    same queries, hits, warp passes and active lanes; without groups every
    query tests all 199 primitives and enters no group, with them fewer
    tests and some groups."""
    scene, p = _config_txt(dev)
    cam = camera.camera_at(p.camera_path, 0, p.num_frames, 64, 48, p.fov_degrees, device=dev)
    n = scene.num_spheres + scene.num_planes
    for kw in (dict(), dict(record=True), dict(rng_mode="reference")):
        on = megakernel.loop_work(scene, cam, 64, 48, 4, 50, **kw)
        off = megakernel.loop_work(scene._replace(groups=None), cam, 64, 48, 4, 50, **kw)
        assert (on.queries, on.hits, on.passes, on.active_lanes) == (
            off.queries, off.hits, off.passes, off.active_lanes), kw
        assert off.tests == n * off.queries and off.visits == 0 and off.node_tests == 0
        assert 0 < on.visits < 3 * on.queries and 0 < on.tests < 0.5 * n * on.queries


def test_loop_work_counts_the_plain_queries(dev):
    """The counted instantiation's nearest-hit queries against the plain
    count: exact where every ray misses, and where the paths' lengths leave
    no razor-edge decision to the rounding, near elsewhere; every pass
    counts its active lanes once per warp."""
    w, h, spp = 32, 24, 3
    sky = megakernel.loop_work(sky_scene(dev), sky_camera(w, h, dev), w, h, spp, 8)
    assert sky.queries == sky.active_lanes == w * h * spp and sky.hits == 0
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], w, h, 55.0,
                                   background=SKY, device=dev)
    plain = renderer.query_count(scene, cam, w, h, spp, 8, rr_start=2)
    for kw in (dict(), dict(record=True), dict(cluster_k=2)):
        work = megakernel.loop_work(scene, cam, w, h, spp, 8, rr_start=2, **kw)
        assert abs(work.queries - plain) <= 1e-3 * plain, kw
        assert work.queries == work.active_lanes and work.hits < work.queries
        assert w * h // 32 * spp <= work.passes and 0.0 < work.lane_utilisation <= 1.0
    closed = megakernel.loop_work(closed_box(dev), _closed_camera(dev), w, h, spp, 4)
    plain = renderer.query_count(closed_box(dev), _closed_camera(dev), w, h, spp, 4)
    assert abs(closed.queries - plain) <= 1e-3 * plain
    assert w * h * spp * 4 * 0.99 <= closed.queries <= w * h * spp * 4


@pytest.mark.parametrize("name", ["one-winner", "many-winners"])
def test_backward_kernel_groups_lanes_by_winner(dev, name):
    """K2 sums each winner's column over the lanes that share it: against
    the plain replay where every primary hit is the floor quad (a camera
    facing it), and where the winners differ (300 spheres)."""
    if name == "one-winner":
        scene = full_scene(dev)
        cam = camera.build_camera_data([0.0, -6.0, 20.0], [0.0, -6.0, 0.0], 40, 30, 10.0,
                                       vup=(0.0, 1.0, 0.0), background=SKY, device=dev)
    else:
        scene = big_scene(300, dev)
        cam = camera.build_camera_data([0, -30, 6], [0, 0, 2], 40, 30, 50.0, background=SKY,
                                       device=dev)
    out = megakernel.render_frame_kernel_record(scene, cam, 40, 30, 2, 5, tape_fields=13)
    floor = scene.num_spheres
    primary = out[1][:, 0]
    if name == "one-winner":
        assert bool((primary == floor).all())
    else:
        assert len(torch.unique(primary)) > 20
    table, camv = bwd.pack_tables(scene, cam)
    idx2 = out[1].reshape(10, -1)
    t2 = bwd._field_major(out[2], 2, 5, 1200) if len(out) == 3 else None
    g2 = torch.randn((1200, 3), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    got = bwd.bwd_kernel(table, camv, idx2, g2, 40, 2, 5, t2=t2)
    want = replay.replay_cotangents(table, camv, idx2, g2, 40, 2, 5, t2=t2)
    for (leaf, a), (_, b) in zip(bwd.leaf_grads(scene, cam, got[0], got[1]),
                                 bwd.leaf_grads(scene, cam, want[0], want[1])):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), leaf


def test_backward_grid_is_one_wave_of_resident_blocks(dev):
    """The register budget (__launch_bounds__(128, 4)) keeps 4 blocks an SM
    resident; the grid is that wave on every SM, or a block for each 128
    pixels of a smaller band."""
    scene = full_scene(dev)
    table, _ = bwd.pack_tables(scene, camera.build_camera_data(
        [5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 8, 8, 55.0, device=dev))
    per_sm = bwd.blocks_per_sm(True, table.shape[1])
    assert 4 <= per_sm <= 2048 // bwd.THREADS
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert bwd.grid_blocks(1200, True, table.shape[1], dev) == 10
    assert bwd.grid_blocks(800 * 600, True, table.shape[1], dev) == sms * per_sm


# ---- the depth-independent gradient path and the replay modes -------------

def _full_cam(dev, w, h):
    return camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], w, h, 55.0,
                                    background=SKY, device=dev)


def test_record_kernel_three_field_tape_is_the_nine_field_head(dev):
    scene, cam = full_scene(dev), _full_cam(dev, 64, 48)
    three = megakernel.render_frame_kernel_record(scene, cam, 64, 48, 4, 8, rr_start=3,
                                                  tape_fields=3)
    nine = megakernel.render_frame_kernel_record(scene, cam, 64, 48, 4, 8, rr_start=3,
                                                 tape_fields=9)
    bits = lambda t: t.contiguous().view(torch.int32)
    assert torch.equal(bits(three[0]), bits(nine[0])) and torch.equal(three[1], nine[1])
    assert torch.equal(bits(three[2]), bits(nine[2][..., :3]))
    assert (three[2] != 1.0).any()


def test_record_kernel_zero_fields_is_the_index_tape_alone(dev):
    scene, cam = full_scene(dev), _full_cam(dev, 64, 48)
    zero = megakernel.render_frame_kernel_record(scene, cam, 64, 48, 4, 8, rr_start=3,
                                                 tape_fields=0)
    nine = megakernel.render_frame_kernel_record(scene, cam, 64, 48, 4, 8, rr_start=3,
                                                 tape_fields=9)
    bits = lambda t: t.contiguous().view(torch.int32)
    assert len(zero) == 2
    assert torch.equal(bits(zero[0]), bits(nine[0])) and torch.equal(zero[1], nine[1])


@pytest.mark.parametrize("texture_grads", [False, True], ids=["9-fields", "13-fields"])
def test_chunked_kernels_match_one_shot(dev, texture_grads):
    """scene_grads_chunked on the card against render_frame_diff's one-shot
    backward: the chunks record the same paths, so every leaf agrees to 1e-4
    of its max|g| (atomic addition order)."""
    scene, cam = full_scene(dev), _full_cam(dev, 40, 30)
    g_fb = torch.randn((30, 40, 3), generator=torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    before = (megakernel.LAUNCHES_RECORD, bwd.LAUNCHES, tex_scatter.LAUNCHES)
    g_scene, g_cam = bwd.scene_grads_chunked(scene, cam, g_fb, 40, 30, 4, 12, spp_chunk=2,
                                             rr_start=3, texture_grads=texture_grads)
    assert (megakernel.LAUNCHES_RECORD, bwd.LAUNCHES, tex_scatter.LAUNCHES) == (
        before[0] + 2, before[1] + 2, before[2] + 2 * texture_grads)
    leaves = [x.detach().clone().requires_grad_() for x in bwd.float_leaves(scene, cam)]
    sc, cm = bwd.with_float_leaves(scene, cam, leaves)
    if texture_grads:
        sc = sc._replace(textures=sc.textures.detach().clone().requires_grad_())
        leaves.append(sc.textures)
    fb = diff.render_frame_diff(sc, cm, 40, 30, 4, 12, rr_start=3, texture_grads=texture_grads)
    want = torch.autograd.grad(fb, leaves, g_fb)
    got = bwd.float_grads(scene, g_scene, g_cam) + ([g_scene.textures] if texture_grads else [])
    for name, a, b in zip(bwd.leaf_names(scene, cam) + ["textures"], got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name


def test_l2_grads_deep_loss_is_the_kernel_frame_loss(dev):
    scene, cam = full_scene(dev), _full_cam(dev, 40, 30)
    target = torch.rand((30, 40, 3), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    before = megakernel.LAUNCHES
    loss, g_scene, g_cam = bwd.l2_grads_deep(scene, cam, target, 40, 30, 4, 50, spp_chunk=2,
                                             fwd_spp_chunk=2)
    assert megakernel.LAUNCHES == before + 2
    fb = megakernel.render_frame_kernel(scene, cam, 40, 30, 4, 50)
    np.testing.assert_allclose(float(loss), float(torch.mean((fb / 4 - target) ** 2)), rtol=1e-5)
    assert all(bool(torch.isfinite(x).all()) for x in bwd.float_grads(scene, g_scene, g_cam))


@pytest.mark.parametrize("mode", ["replay", "replay-sample"])
def test_replay_modes_on_the_card(dev, mode):
    """The plain replay backward on CUDA tensors (no backward-kernel
    launch): the material colours' gradients equal replay-kernel's."""
    scene, cam = full_scene(dev), _full_cam(dev, 40, 30)
    g_fb = torch.randn((30, 40, 3), generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev)
    grads = {}
    for m in ("replay-kernel", mode):
        leaves = [x.detach().clone().requires_grad_() for x in bwd.float_leaves(scene, cam)]
        before = bwd.LAUNCHES
        fb = diff.render_frame_diff(*bwd.with_float_leaves(scene, cam, leaves), 40, 30, 2, 8,
                                    mode=m, rr_start=3)
        grads[m] = dict(zip(bwd.leaf_names(scene, cam), torch.autograd.grad(fb, leaves, g_fb)))
        assert bwd.LAUNCHES == before + (m == "replay-kernel")
    for name in ("materials.albedo", "materials.emit"):
        a, b = grads[mode][name], grads["replay-kernel"][name]
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name


# ---- stratified jitter (strat_k) ---------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(cluster_k=16), dict(intersector="bvh")],
                         ids=["K1", "K1-cl", "K1-bvh"])
def test_stratified_kernels_match_plain(dev, kw):
    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    scene = builders.create_scene(params, with_bvh=True, texture_loader=lambda _p: None,
                                  device=dev)
    cam = camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 64, 48, 90.0,
                                   background=SKY, device=dev)
    got = megakernel.render_frame_kernel(scene, cam, 64, 48, 4, 8, stratify=True, **kw)
    want = renderer.render_frame(scene, cam, 64, 48, 4, 8, stratify=True, **kw)
    _agree(got, want)
    # a chunk of a larger frame: its grid and its first sample
    got = megakernel.render_frame_kernel(scene, cam, 64, 48, 5, 6, stratify=True,
                                         strat_sqrt_spp=3, sample_start=4, **kw)
    want = renderer.render_frame(scene, cam, 64, 48, 5, 6, stratify=True, strat_sqrt_spp=3,
                                 sample_start=4, **kw)
    _agree(got, want)


def test_stratified_record_and_backward_match_plain(dev):
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 40, 30, 55.0,
                                   background=SKY, device=dev)
    got = megakernel.render_frame_kernel_record(scene, cam, 40, 30, 4, 6, rr_start=3,
                                                tape_fields=13, stratify=True)
    want = renderer.render_frame_record(scene, cam, 40, 30, 4, 6, rr_start=3, tape_fields=13,
                                        stratify=True)
    _agree_record(got, want)
    table, camv = bwd.pack_tables(scene, cam)
    idx2 = got[1].reshape(24, -1)
    t2 = bwd._field_major(got[2], 4, 6, 1200)
    g2 = torch.randn((1200, 3), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    kw = dict(rr_start=3, t2=t2, want_texgrad=True, strat_k=2)
    k2 = bwd.bwd_kernel(table, camv, idx2, g2, 40, 4, 6, **kw)
    plain = replay.replay_cotangents(table, camv, idx2, g2, 40, 4, 6, **kw)
    for (name, a), (_, b) in zip(bwd.leaf_grads(scene, cam, k2[0], k2[1]),
                                 bwd.leaf_grads(scene, cam, plain[0], plain[1])):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), name
    # K2 regenerates the recorded rays: its replayed frame is the record's
    torch.testing.assert_close(k2[2], got[0].reshape(-1, 3), rtol=0,
                               atol=1e-4 * float(got[0].abs().max()))


def test_chunked_stratified_gradients_match_one_shot(dev):
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 32, 24, 55.0,
                                   background=SKY, device=dev)
    g_fb = torch.randn((24, 32, 3), generator=torch.Generator(device=dev).manual_seed(2),
                       device=dev)
    out = megakernel.render_frame_kernel_record(scene, cam, 32, 24, 4, 6, stratify=True)
    one = bwd.scene_cam_grads(scene, cam, out[1], g_fb, 32, 24, 4, 6, tex_tape=out[2],
                              stratify=True)[:2]
    chunked = bwd.scene_grads_chunked(scene, cam, g_fb, 32, 24, 4, 6, spp_chunk=2,
                                      stratify=True)
    for a, b in zip(bwd.float_grads(scene, *chunked), bwd.float_grads(scene, *one)):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)


# ---- the BVH kernel (K1-bvh) ---------------------------------------------------

def _bvh_case(name, dev):
    if name == "field1000":  # 1000 child-pair records, 64 KB: above NODE_SHARED_BYTES_MAX
        scene, _ = sphere_field(1000, dev)
        scene = scene._replace(bvh=bvh_builder.build_scene_bvh_from_scene(scene))
        params = config.read_scene_params(io.StringIO(config.default_config_text()))
        # the canonical path's frame 1 over the field, black background, as
        # chip_smoke's phase 10: more bounces or a sky turn more of the
        # field's last-bit differences (the kernel's float code against
        # torch's CUDA ops) into other paths, for K1 as for K1-bvh
        return scene, camera.camera_at(params.camera_path, 1, params.num_frames, 64, 48,
                                       params.fov_degrees, device=dev)
    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    scene = builders.create_scene(params, with_bvh=True, texture_loader=lambda _p: None,
                                  device=dev)
    return scene, camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 64, 48, 90.0,
                                           background=SKY, device=dev)


@pytest.mark.parametrize("name, rr_start, depth", [("smoke", None, 6), ("smoke", 3, 6),
                                                   ("field1000", None, 3)])
def test_bvh_kernel_matches_plain(dev, name, rr_start, depth):
    scene, cam = _bvh_case(name, dev)
    nodes = 4 * pack.pack_bvh(scene, megakernel.BVH_STACK).numel()
    assert (nodes > megakernel.NODE_SHARED_BYTES_MAX) == (name == "field1000")
    before = (megakernel.LAUNCHES, megakernel.LAUNCHES_BVH)
    got = megakernel.render_frame_kernel(scene, cam, 64, 48, 2, depth, rr_start=rr_start,
                                         intersector="bvh")
    assert (megakernel.LAUNCHES, megakernel.LAUNCHES_BVH) == (before[0], before[1] + 1)
    want = renderer.render_frame(scene, cam, 64, 48, 2, depth, rr_start=rr_start,
                                 intersector="bvh")
    _agree(got, want)
    _agree(got, megakernel.render_frame_kernel(scene, cam, 64, 48, 2, depth, rr_start=rr_start))


@pytest.mark.parametrize("name", ["smoke", "field1000"])
def test_bvh_nodes_in_shared_and_global_memory_give_the_same_frame(dev, monkeypatch, name):
    """K1-bvh, its counted instantiation and K1-bvh-ref render the same
    frame with the child-pair records in shared and in global memory (the
    walk's stack lives in local memory in both)."""
    scene, cam = _bvh_case(name, dev)
    depth = 6 if name == "smoke" else 3
    nodes = 4 * pack.pack_bvh(scene, megakernel.BVH_STACK).numel()

    def frames():
        counts = torch.zeros(len(megakernel.COUNT_NAMES), dtype=torch.int64, device=dev)
        return (megakernel.render_frame_kernel(scene, cam, 64, 48, 2, depth, intersector="bvh"),
                megakernel._render_bvh(scene, cam, 64, 48, 2, depth, True, None, 0, counts),
                megakernel.render_frame_kernel(scene, cam, 64, 48, 2, depth, intersector="bvh",
                                               rng_mode="reference"))

    monkeypatch.setattr(megakernel, "NODE_SHARED_BYTES_MAX", nodes)
    shared = frames()
    monkeypatch.setattr(megakernel, "NODE_SHARED_BYTES_MAX", -1)
    glob = frames()
    assert torch.equal(shared[0], shared[1])  # counting changes no decision
    for a, b in zip(shared, glob):
        assert torch.equal(a, b)


def test_bvh_work_counts_the_plain_walk(dev):
    """The counted K1-bvh's node tests, leaves and primitive tests against
    the plain traversal's, primary rays only (depth 1: no FMA-moved
    bounce origins)."""
    scene, cam = _bvh_case("smoke", dev)
    work = megakernel.loop_work(scene, cam, 64, 48, 1, 1, intersector="bvh")
    i, j, seeds = renderer.pixel_grid(64, 48, device=dev)
    plain = []
    renderer.render_pixels(scene, cam, i, j, seeds, 1, 1, intersector="bvh", work=plain)
    node_tests, leaves, tests = (int(x) for x in plain[0])
    assert work.queries == 64 * 48 and work.visits == work.tests
    assert abs(work.node_tests - node_tests) <= 0.01 * node_tests
    assert abs(work.visits - leaves) <= 0.01 * leaves


def test_bvh_kernel_culls_the_nan_face_ray(dev):
    """Every ray starts on the root box's x = -1 face with direction x
    exactly 0, so each slab test meets 0 x inf = NaN and culls the box,
    as tracer's and the plain traversal's NaN-propagating min/max do; the
    brute kernel hits the quad's edge."""
    planes = T.make_planes([T.QUAD], [[-1, -1, 0]], [[2, 0, 0]], [[0, 2, 0]], [0], dev)
    scene = T.Scene(
        spheres=T.make_spheres(np.zeros((0, 3)), [], [], dev), planes=planes,
        materials=T.make_materials([T.LAMBERTIAN], [0.0], [1.0], [[0, 0, 0]],
                                   [[0.8, 0.6, 0.4]], [[0, 0, 0]], [-1], dev),
        textures=None)
    scene = scene._replace(bvh=bvh_builder.build_scene_bvh_from_scene(scene))
    assert float(scene.bvh.box_min[0, 0]) == -1.0
    f = lambda *x: torch.tensor(x, dtype=torch.float32, device=dev)
    cam = camera.CameraData(f(-1, 0, 5), f(-1, -0.5, 4), f(0, 1 / 16, 0), f(0, 0, -1 / 64),
                            f(0.05, 0.07, 0.1))
    got = megakernel.render_frame_kernel(scene, cam, 16, 8, 1, 2, intersector="bvh")
    want = renderer.render_frame(scene, cam, 16, 8, 1, 2, intersector="bvh")
    assert torch.equal(got, want)
    assert torch.equal(got, cam.background.expand_as(got))
    assert not torch.allclose(megakernel.render_frame_kernel(scene, cam, 16, 8, 1, 2), got)


def test_gpu_bvh_without_a_cuda_device_exits_1(dev, tmp_path):
    text = config.smoke_config_text().replace("200 100 90", "48 32 90")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-m", "tracer_torch.cli", "--gpu", "--bvh"],
                       input=text, capture_output=True, text=True, cwd=tmp_path, env=env,
                       timeout=240)
    assert r.returncode == 1 and "needs a CUDA device" in r.stderr


def test_kernel_build_failure_raises(dev, monkeypatch, tmp_path):
    """A kernel that does not build raises; nothing renders on the plain
    version instead."""
    scene, cam = _bvh_case("smoke", dev)
    (tmp_path / "megakernel.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(nvcc, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(nvcc, "BUILD_DIR", tmp_path / "build")
    nvcc.build_all.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc failed for megakernel.cu"):
            megakernel.render_frame_kernel(scene, cam, 8, 8, 1, 1, intersector="bvh")
    finally:
        nvcc.build_all.cache_clear()


@pytest.mark.parametrize("height, n, stratify", [(30, 3, False), (29, 2, False), (29, 3, True)])
def test_kernel_row_bands_are_bit_equal_to_one_launch(dev, height, n, stratify):
    """K1 and K1-rec on each rank's row band (`row_offset`) against the rows
    of one launch, bit for bit: frame, index tape and 9-field tape, uneven
    splits included."""
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 40, height, 55.0,
                                   background=SKY, device=dev)
    kw = dict(rr_start=3, stratify=stratify)
    full = megakernel.render_frame_kernel(scene, cam, 40, height, 4, 6, **kw)
    rec = megakernel.render_frame_kernel_record(scene, cam, 40, height, 4, 6, tape_fields=9, **kw)
    for rank in range(n):
        r0, rows = sharding.row_band(height, n, rank)
        cols = slice(r0 * 40, (r0 + rows) * 40)
        band = megakernel.render_frame_kernel(scene, cam, 40, rows, 4, 6, row_offset=r0, **kw)
        brec = megakernel.render_frame_kernel_record(scene, cam, 40, rows, 4, 6, tape_fields=9,
                                                     row_offset=r0, **kw)
        assert torch.equal(band, full[r0:r0 + rows])
        assert torch.equal(brec[0], rec[0][r0:r0 + rows])
        assert torch.equal(brec[1], rec[1][:, :, cols])
        assert torch.equal(brec[2], rec[2][:, :, cols])


@pytest.mark.parametrize("kw", [dict(cluster_k=16), dict(intersector="bvh")],
                         ids=["K1-cl", "K1-bvh"])
def test_clustered_and_bvh_row_bands_are_bit_equal_to_one_launch(dev, kw):
    scene, cam = _bvh_case("smoke", dev)
    w, h = 16, 8
    full = megakernel.render_frame_kernel(scene, cam, w, h, 2, 5, **kw)
    band = megakernel.render_frame_kernel(scene, cam, w, 5, 2, 5, row_offset=3, **kw)
    assert torch.equal(band, full[3:])


def test_sharded_kernel_paths_on_one_nccl_rank(dev, tmp_path):
    """render_frame_kernel_sharded and l2_grads_deep_sharded in an NCCL group
    of one rank: the frame and the loss bit-equal to the one-device ones,
    the gradients within 1e-4 of each leaf's max|g| (K2 adds with atomics)."""
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = sharding.make_mesh(dev)
        scene = full_scene(dev)
        cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 40, 30, 55.0,
                                       background=SKY, device=dev)
        got = sharding.render_frame_kernel_sharded(scene, cam, 40, 30, 4, 6, mesh)
        assert torch.equal(got, megakernel.render_frame_kernel(scene, cam, 40, 30, 4, 6))
        target = torch.rand((30, 40, 3), generator=torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        kw = dict(spp_chunk=2, texture_grads=True)
        l1, gs1, gc1 = sharding.l2_grads_deep_sharded(scene, cam, target, 40, 30, 4, 6, mesh, **kw)
        l0, gs0, gc0 = bwd.l2_grads_deep(scene, cam, target, 40, 30, 4, 6, **kw)
        assert torch.equal(l1, l0)
        for a, b in zip(bwd.float_grads(scene, gs1, gc1) + [gs1.textures],
                        bwd.float_grads(scene, gs0, gc0) + [gs0.textures]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
    finally:
        dist.destroy_process_group()


# ---- K1-ref: the reference-stream kernel (rng_mode="reference") ----

@pytest.mark.parametrize("intersector", ["brute", "bvh"])
@pytest.mark.parametrize("name, quirk, stratify", [("smoke", True, False), ("smoke", False, True),
                                                   ("full", True, False)])
def test_reference_kernel_matches_plain(dev, name, quirk, stratify, intersector):
    if name == "smoke":
        scene, cam = _bvh_case("smoke", dev)
    else:
        scene = full_scene(dev)
        scene = scene._replace(bvh=bvh_builder.build_scene_bvh_from_scene(scene))
        cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 64, 48, 55.0,
                                       background=SKY, device=dev)
    kw = dict(reference_quirk=quirk, stratify=stratify, intersector=intersector,
              rng_mode="reference")
    before = (megakernel.LAUNCHES, megakernel.LAUNCHES_BVH, megakernel.LAUNCHES_REF)
    got = megakernel.render_frame_kernel(scene, cam, 64, 48, 4, 8, **kw)
    assert (megakernel.LAUNCHES, megakernel.LAUNCHES_BVH, megakernel.LAUNCHES_REF) == (
        before[0], before[1], before[2] + 1)
    want = renderer.render_frame(scene, cam, 64, 48, 4, 8, **kw)
    _agree(got, want)
    fixed = megakernel.render_frame_kernel(scene, cam, 64, 48, 4, 8, reference_quirk=quirk,
                                           stratify=stratify, intersector=intersector)
    assert (fixed - got).abs().max() > 1e-3  # another stream


def test_reference_kernel_chunks_bands_and_records_in_global_memory(dev, monkeypatch):
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 40, 30, 55.0,
                                   background=SKY, device=dev)
    ref = dict(rng_mode="reference")
    one = megakernel.render_frame_kernel(scene, cam, 40, 30, 6, 6, **ref)
    two = (megakernel.render_frame_kernel(scene, cam, 40, 30, 2, 6, **ref)
           + megakernel.render_frame_kernel(scene, cam, 40, 30, 4, 6, sample_start=2, **ref))
    torch.testing.assert_close(two, one, rtol=1e-5, atol=1e-5)
    band = megakernel.render_frame_kernel(scene, cam, 40, 11, 6, 6, row_offset=13, **ref)
    assert torch.equal(band, one[13:24])
    monkeypatch.setattr(megakernel, "TABLE_SHARED_BYTES_MAX", 0)
    assert torch.equal(megakernel.render_frame_kernel(scene, cam, 40, 30, 6, 6, **ref), one)


@pytest.mark.parametrize("seed", EXHAUSTED_SEEDS[:4])
def test_reference_kernel_takes_the_exhausted_lane_tail(dev, seed):
    """A one-pixel launch whose first bounce draws its hemisphere direction
    from a seed that exhausts the 16 tries: the kernel takes the normal into
    the light, as the plain version does (floor albedo 0.5 x emission)."""
    scene, cam = exhausted_lane_view(dev)
    base = int(renderer.pixel_grid(1, 1, device=dev)[2][0])
    start = sample_start_reaching(seed, base)
    got = megakernel.render_frame_kernel(scene, cam, 1, 1, 1, 6, sample_start=start,
                                         rng_mode="reference")
    want = renderer.render_frame(scene, cam, 1, 1, 1, 6, sample_start=start,
                                 rng_mode="reference")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got.reshape(3).cpu(), torch.tensor([3.0, 2.5, 2.0]), rtol=1e-6,
                               atol=0.0)


def test_reference_kernel_counts_the_plain_queries_and_refuses(dev):
    scene = full_scene(dev)
    cam = camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 32, 24, 55.0,
                                   background=SKY, device=dev)
    work = megakernel.loop_work(scene, cam, 32, 24, 3, 8, rng_mode="reference")
    plain = renderer.query_count(scene, cam, 32, 24, 3, 8, rng_mode="reference")
    assert abs(work.queries - plain) <= 1e-3 * plain and work.queries == work.active_lanes
    for kw, msg in ((dict(rr_start=2), "rr_start requires"), (dict(cluster_k=4), "cluster_k"),):
        with pytest.raises(ValueError, match=msg):
            megakernel.render_frame_kernel(scene, cam, 8, 8, 1, 2, rng_mode="reference", **kw)
    with pytest.raises(ValueError, match="counted reference-stream kernel is brute force only"):
        megakernel.loop_work(scene, cam, 8, 8, 1, 2, rng_mode="reference", record=True)


def test_cli_gpu_ref_rng_retries_renders_the_kernel_frame(dev, tmp_path):
    """`--gpu --ref-rng --retries 2` renders with K1-ref: its frame is the
    driver's rng_mode="reference" frame on the card."""
    text = config.smoke_config_text().replace("200 100 90", "48 32 90").replace(
        "test_output_%d.png", str(tmp_path / "out_%d.bin"))
    env = dict(os.environ,
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    r = subprocess.run([sys.executable, "-m", "tracer_torch.cli", "--gpu", "--ref-rng",
                        "--retries", "2"], input=text, capture_output=True, text=True,
                       cwd=tmp_path, env=env, timeout=240)
    assert r.returncode == 0, r.stderr
    from tracer_torch.io import image as image_io
    from tracer_torch.render import driver

    cli_frame = image_io.read_binary(str(tmp_path / "out_0.bin"))
    params = config.read_scene_params(io.StringIO(text))
    scene = builders.create_scene(params, texture_loader=lambda _p: None, device=dev)
    before = megakernel.LAUNCHES_REF
    fb = driver.render_animation(scene, params, engine="cuda", rng_mode="reference",
                                 out=io.StringIO(), saver="bin")
    assert megakernel.LAUNCHES_REF == before + 1
    np.testing.assert_array_equal(cli_frame, image_io.quantize(fb, 2))


def test_driver_overlap_writes_the_serial_frames(dev, tmp_path):
    """render_animation one frame deep on the card (frame n's copy and hand-
    off while frame n+1 renders) writes the files and returns the array of
    the serial order (retries=1: each frame waited for before the next), bit
    for bit, over 3 frames of K1-bvh in 4 chunks each; each TSV `ms` is the
    frame's own event time, above 0."""
    from tracer_torch.render import driver

    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    params.width, params.height, params.num_frames = 64, 48, 3
    params.render.sqrt_rays_per_pixel = 4
    scene = builders.create_scene(params, with_bvh=True, texture_loader=lambda _p: None,
                                  device=dev)
    got = {}
    for retries in (0, 1):
        folder = tmp_path / f"r{retries}"
        folder.mkdir()
        params.output_path = str(folder / "out_%d.bin")
        out, before = io.StringIO(), driver.FRAMES_AHEAD
        fb = driver.render_animation(scene, params, engine="cuda", saver="bin", out=out,
                                     intersector="bvh", spp_chunk=4, retries=retries)
        lines = [x.split("\t") for x in out.getvalue().splitlines()]
        assert [x[0] for x in lines] == ["0", "1", "2"]
        assert all(float(x[1]) > 0 for x in lines)
        got[retries] = (fb, driver.FRAMES_AHEAD - before,
                        [(folder / f"out_{n}.bin").read_bytes() for n in range(3)])
    (fb, ahead, files), (fb_s, ahead_s, files_s) = got[0], got[1]
    assert (ahead, ahead_s) == (2, 0)
    np.testing.assert_array_equal(fb, fb_s)
    assert files == files_s and fb.any()


# ---- the pixel pool: one wave of blocks, each lane refilled from a counter ----

def _pool_case(name, dev):
    """(scene, camera maker (w, h) -> camera, render kwargs) of K1, K1-bvh
    and K1-bvh's RTIOW instantiation."""
    params = config.read_scene_params(io.StringIO(config.default_config_text()))
    if name == "K1":
        scene = full_scene(dev)
        return scene, lambda w, h: camera.build_camera_data(
            [5.0, -6.0, 3.0], [0.0, 0.0, 1.0], w, h, 55.0, background=SKY, device=dev), {}
    if name == "K1-bvh":
        scene, _ = sphere_field(1000, dev)
        scene = scene._replace(bvh=bvh_builder.build_scene_bvh_from_scene(scene))
        return scene, lambda w, h: camera.camera_at(params.camera_path, 1, params.num_frames, w,
                                                    h, params.fov_degrees, device=dev), \
            dict(intersector="bvh")
    from rtbench.harness import spec

    kind = spec.scene_kind("rtiow_final")
    cfg = kind.tiny(spec.load_json(spec.BENCH_DIR / "configs" / "rtiow_final.json"))
    scene, p = kind.program(kind.inputs(cfg, 1, dev), cfg, dev, with_bvh=True)
    return scene, lambda w, h: camera.camera_at(p.camera_path, 0, p.num_frames, w, h,
                                                p.fov_degrees, device=dev), \
        dict(intersector="bvh")


def _above_any_wave(dev):
    """(w, h): more pixels than the card holds threads at once, so the
    lanes take pixels from the pool, and a count that is no multiple of 128."""
    props = torch.cuda.get_device_properties(dev)
    w = 641
    h = props.multi_processor_count * props.max_threads_per_multi_processor // w + 2
    return w, h + 1 - h % 2


POOL_CASES = ["K1", "K1-bvh", "RTIOW"]


@pytest.mark.parametrize("name", POOL_CASES)
def test_pool_writes_every_pixel_once_and_repeats_bit_for_bit(dev, name):
    """Above one wave and below it (37x23 = 851 pixels), with a pixel count
    that is no multiple of 128: every pixel of a NaN-filled frame is
    written, and two launches in a row give the same frame, so each
    launch's counter starts from zero."""
    scene, cam_of, kw = _pool_case(name, dev)
    mode = megakernel.MODE_BVH if kw else megakernel.MODE_RENDER
    for w, h in (_above_any_wave(dev), (37, 23)):
        cam = cam_of(w, h)
        mode_k = megakernel._kernel_mode(mode, scene, cam)
        assert (mode_k == megakernel.MODE_BVH_RTIOW) == (name == "RTIOW")
        _, tex = megakernel._prepare(scene, cam, w, h, 1, 6, None, 0, 0)
        nodes = pack.pack_bvh(scene, megakernel.BVH_STACK) if kw else None
        out = torch.full((h, w, 3), float("nan"), device=dev)
        err = megakernel._launch(mode_k, scene, cam, tex, out, w, h, 1, 6, 0, True, None,
                                 nodes=nodes)
        assert err == 0
        again = megakernel.render_frame_kernel(scene, cam, w, h, 1, 6, **kw)
        assert torch.isfinite(out).all() and float(out.sum()) > 0
        assert torch.equal(out, again)
        assert torch.equal(again, megakernel.render_frame_kernel(scene, cam, w, h, 1, 6, **kw))


@pytest.mark.parametrize("name", POOL_CASES)
def test_pool_frame_is_its_row_bands_stacked(dev, name):
    """A frame above one wave against its three row bands (`row_offset`),
    bit for bit; the counted launch's counters that the paths fix (queries,
    hits, groups or leaves, primitive and node tests, samples) are the
    sums of its bands' counted launches, and the tail's passes are passes."""
    scene, cam_of, kw = _pool_case(name, dev)
    w, h = _above_any_wave(dev)
    cam = cam_of(w, h)
    full = megakernel.render_frame_kernel(scene, cam, w, h, 2, 6, **kw)
    work = megakernel.loop_work(scene, cam, w, h, 2, 6, **kw)
    bands, sums = [], dict.fromkeys(("queries", "hits", "visits", "tests", "node_tests",
                                     "samples"), 0)
    for rank in range(3):
        r0, rows = sharding.row_band(h, 3, rank)
        bands.append(megakernel.render_frame_kernel(scene, cam, w, rows, 2, 6, row_offset=r0,
                                                    **kw))
        part = megakernel.loop_work(scene, cam, w, rows, 2, 6, row_offset=r0, **kw)
        for k in sums:
            sums[k] += getattr(part, k)
        assert 0 < part.drained_passes <= part.passes
    assert torch.equal(torch.cat(bands), full)
    assert {k: getattr(work, k) for k in sums} == sums
    assert work.samples == w * h * 2 and work.queries == work.active_lanes
    assert 0 < work.drained_passes <= work.passes


def test_pool_record_tapes_repeat_bit_for_bit(dev):
    """K1-rec above one wave: two launches give the same frame, index tape
    and 13-field texture tape (each slot is indexed by its pixel, whatever
    lane takes it)."""
    scene = full_scene(dev)
    w, h = _above_any_wave(dev)
    cam = _full_cam(dev, w, h)
    one = megakernel.render_frame_kernel_record(scene, cam, w, h, 1, 4, tape_fields=13)
    two = megakernel.render_frame_kernel_record(scene, cam, w, h, 1, 4, tape_fields=13)
    assert len(one) == 3 and int((one[1] >= 0).sum()) > w * h // 2
    for a, b in zip(one, two):
        assert torch.equal(a, b)
    assert torch.equal(one[0], megakernel.render_frame_kernel(scene, cam, w, h, 1, 4))
