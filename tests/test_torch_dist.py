"""tracer_torch.dist on the CPU, with gloo process groups of 2 and 3 ranks
(each rank a process of tests/torch_dist_worker.py, all checks of a group
in one spawn), against the port's one-device functions and tracer.dist on
the conftest's 8-device CPU mesh.

Inputs: the smoke scene at 16x7 (spp 4, depth 3) for the frames, tests/
test_grad.py's tie-free scene with a ramp texture on sphere 0 at 12x7
(7 rows: uneven bands over 2 and 3 ranks) for the gradients, a target
from numpy seed 4, and the canonical config at 16x7 (3 frames) for the
multihost driver.

Tolerances: pixel- and row-sharded frames (fixed and reference RNG
streams) are bit-equal to the one-device frame (seeds depend only on pixel and global sample; the all_reduce adds
exact zeros); sample-sharded frames within a relative 1e-6 (their sample
sums are grouped per rank); sharded gradients within 1e-5 of the leaf's
max|g| of the one-device gradients (the all_reduce sums partial
gradients in another order), losses within a relative 1e-6, and
l2_grads_deep_sharded's loss bit-equal (its frame is). Against tracer:
frames by tests/test_torch_render.py's rule, gradients by tests/
test_grad.py's _cmp rule.
"""

import io
import json
import os
import socket
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from tracer.dist import sharding as jax_sharding
from tracer.render import camera as jax_camera
from tracer.scene import types as jax_T
from tracer_torch.dist import multihost, sharding
from tracer_torch.io import image as image_io
from tracer_torch.kernels import bwd, diff
from tracer_torch.render import driver, renderer

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_worker as worker  # noqa: E402
from test_torch_render import _smoke, assert_frames_agree  # noqa: E402
from test_torch_scene import jax_cam_fields, jax_scene_fields, torch_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401
from torch_scenes import SKY, full_scene, tie_free_scene  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUB_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
W, H = 16, 7  # the frames
GW, GH = 12, 7  # the gradients
WORLDS = (2, 3)
ROUTES = ("remat", "replay", "deep")


def _jax_frame_inputs():
    jscene = _smoke(jax_side=True)
    jcam = jax_camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], W, H, 90.0,
                                        background=SKY)
    return jscene, jcam


def _jax_grad_inputs():
    fields = torch_scene_fields(tie_free_scene("cpu", ramp=True))
    grp = lambda cls, pre: cls(*(jnp.asarray(fields[f"{pre}.{n}"]) for n in cls._fields))
    jscene = jax_T.Scene(grp(jax_T.Spheres, "spheres"), grp(jax_T.Planes, "planes"),
                         grp(jax_T.Materials, "materials"), jnp.asarray(fields["textures"]), None)
    jcam = jax_camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], GW, GH, 55.0,
                                        background=SKY)
    target = np.random.default_rng(4).uniform(0.0, 2.0, size=(GH, GW, 3)).astype(np.float32)
    return jscene, jcam, target


def _inputs():
    """The workers' inputs, keyed as torch_dist_worker.scene_from reads them."""
    out = {}
    for prefix, (jscene, jcam), shape in (("frame.", _jax_frame_inputs(), (H, W)),
                                          ("grad.", _jax_grad_inputs()[:2], (GH, GW))):
        out.update({prefix + k: v for k, v in jax_scene_fields(jscene).items()})
        out.update({f"{prefix}cam.{k}": v for k, v in jax_cam_fields(jcam).items()})
        out[prefix + "shape"] = np.asarray(shape)
    out["grad.target"] = _jax_grad_inputs()[2]
    return out


def _free_ports(k):
    """k distinct ports free when asked (each socket held until all are
    chosen, so two groups never draw the same one). Another process may
    still take one before its group binds it: rank 0 then fails at once."""
    socks = [socket.socket() for _ in range(k)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def runs(tmp_path_factory, inputs):
    """Both groups, spawned together: {world: (out dir, [each rank's results])}."""
    base = tmp_path_factory.mktemp("dist")
    np.savez(base / "inputs.npz", **inputs)
    procs, dirs = [], {}
    for world, port in zip(WORLDS, _free_ports(len(WORLDS))):
        dirs[world] = base / f"world{world}"
        dirs[world].mkdir()
        for rank in range(world):
            log = open(dirs[world] / f"log{rank}.txt", "w")  # a file: a full pipe would stall
            procs.append((log, subprocess.Popen(
                [sys.executable, os.path.join(REPO, "tests", "torch_dist_worker.py"),
                 str(base / "inputs.npz"), str(dirs[world]), f"127.0.0.1:{port}", str(world),
                 str(rank)],
                stdout=log, stderr=subprocess.STDOUT, env=SUB_ENV)))
    # every rank's exit, polled together: the first rank that fails (or the
    # deadline) stops them all, so a group that cannot finish fails fast
    errors = []
    deadline = time.monotonic() + 240
    try:
        while any(p.poll() is None for _, p in procs):
            if any(p.returncode not in (0, None) for _, p in procs):
                break
            if time.monotonic() > deadline:
                errors.append("ranks still running after 240 s")
                break
            time.sleep(0.2)
        for log, p in procs:
            if p.returncode not in (0, None):
                errors.append(f"{p.args[-2:]} exited {p.returncode}:\n"
                              f"{open(log.name).read()[-3000:]}")
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
            log.close()
    assert not errors, "\n".join(errors)
    return {world: (dirs[world], [dict(np.load(dirs[world] / f"rank{r}.npz"))
                                  for r in range(world)]) for world in WORLDS}


def _frame_scene(inputs):
    return worker.scene_from(inputs, "frame.")


def _grad_scene(inputs):
    return worker.scene_from(inputs, "grad.")


@pytest.mark.parametrize("world", WORLDS)
def test_pixel_and_row_sharded_frames_are_bit_equal_to_one_device(runs, inputs, world):
    scene, cam = _frame_scene(inputs)
    want = renderer.render_frame(scene, cam, W, H, worker.SPP, worker.DEPTH).numpy()
    assert want.max() > 0
    for res in runs[world][1]:
        np.testing.assert_array_equal(res["frame"], want)
        np.testing.assert_array_equal(res["frame_rows"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_reference_stream_sharded_frames_match_one_device(runs, inputs, world):
    """rng_mode="reference" over pixel ranges and row bands: bit-equal to the
    one-device frame (a lane's stream depends on its pixel and sample
    only); over sample slices within a relative 1e-6."""
    scene, cam = _frame_scene(inputs)
    want = renderer.render_frame(scene, cam, W, H, worker.SPP, worker.DEPTH,
                                 rng_mode="reference").numpy()
    fixed = renderer.render_frame(scene, cam, W, H, worker.SPP, worker.DEPTH).numpy()
    assert np.abs(want - fixed).max() > 1e-3
    spp_u = 4 if world == 2 else 6
    want_spp = renderer.render_frame(scene, cam, W, H, spp_u, worker.DEPTH,
                                     rng_mode="reference").numpy()
    for res in runs[world][1]:
        np.testing.assert_array_equal(res["frame_ref"], want)
        np.testing.assert_array_equal(res["frame_rows_ref"], want)
        np.testing.assert_allclose(res["spp_ref"], want_spp, rtol=1e-6,
                                   atol=1e-6 * np.abs(want_spp).max())


@pytest.mark.parametrize("world", WORLDS)
def test_reference_stream_multihost_animation_matches_one_process(runs, world, tmp_path):
    """render_animation_multihost passes rng_mode through to the row-sharded
    driver: every rank's last frame is one process's reference-stream frame."""
    scene, params = worker.anim_setup(str(tmp_path / "frame_%d.bin"))
    fb = driver.render_animation(scene, params, engine="torch", out=io.StringIO(),
                                 rng_mode="reference")
    for res in runs[world][1]:
        np.testing.assert_array_equal(res["rows_ref.fb"], fb)


def test_pixel_sharded_frame_matches_tracer_sharded(runs):
    jscene, jcam = _jax_frame_inputs()
    mesh = jax_sharding.make_mesh(jax.devices()[:8])
    want = jax_sharding.render_frame_sharded(jscene, jcam, W, H, worker.SPP, worker.DEPTH, mesh,
                                             chunk=W * H)
    assert_frames_agree(runs[2][1][0]["frame"], want)


@pytest.mark.parametrize("world", WORLDS)
def test_spp_sharded_frames_match_one_device(runs, inputs, world):
    scene, cam = _frame_scene(inputs)
    spp_u, spp_s = (4, 4) if world == 2 else (6, 9)
    for key, spp, kw in (("spp_uniform", spp_u, {}), ("spp_stratified", spp_s,
                                                      dict(stratify=True))):
        want = renderer.render_frame(scene, cam, W, H, spp, worker.DEPTH, **kw).numpy()
        for res in runs[world][1]:
            np.testing.assert_allclose(res[key], want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=key)


def test_spp_sharded_raises_when_spp_does_not_divide(inputs):
    scene, cam = _frame_scene(inputs)
    mesh = sharding.Mesh(None, 3, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        sharding.render_frame_spp_sharded(scene, cam, W, H, 4, 2, mesh)


@pytest.mark.parametrize("r0, rows", [(0, 3), (3, 2), (5, 2), (2, 5)])
def test_plain_band_record_is_the_full_records_rows(r0, rows):
    scene = full_scene("cpu")
    cam = worker.camera.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 10, 7, 55.0,
                                          background=SKY, device="cpu")
    full = renderer.render_frame_record(scene, cam, 10, 7, 2, 4, rr_start=2, tape_fields=13)
    band = renderer.render_frame_record(scene, cam, 10, rows, 2, 4, rr_start=2, tape_fields=13,
                                        row_offset=r0)
    cols = slice(r0 * 10, (r0 + rows) * 10)
    assert torch.equal(band[0], full[0][r0:r0 + rows])
    assert torch.equal(band[1], full[1][:, :, cols])
    assert torch.equal(band[2], full[2][:, :, cols])
    assert (band[1] >= 0).any()


def test_kernel_sharded_raises_on_a_cpu_scene(inputs):
    scene, cam = _frame_scene(inputs)
    mesh = sharding.Mesh(None, 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA kernel"):
        sharding.render_frame_kernel_sharded(scene, cam, W, H, 2, 2, mesh)


def test_row_bands_and_pixel_ranges():
    assert [sharding.row_band(7, 2, r) for r in range(2)] == [(0, 4), (4, 3)]
    assert [sharding.row_band(7, 3, r) for r in range(3)] == [(0, 3), (3, 3), (6, 1)]
    assert [sharding.row_band(5, 4, r) for r in range(4)] == [(0, 2), (2, 2), (4, 1), (5, 0)]
    assert [sharding.pixel_range(112, 3, r) for r in range(3)] == [(0, 38), (38, 76), (76, 112)]


def _one_device(inputs, route):
    """(loss, {leaf path: gradient}) of the port's one-device counterpart."""
    scene, cam = _grad_scene(inputs)
    target = torch.from_numpy(inputs["grad.target"])
    if route == "deep":
        loss, g_scene, g_cam = bwd.l2_grads_deep(scene, cam, target, GW, GH, worker.GSPP,
                                                 worker.GDEPTH, spp_chunk=worker.GCHUNK,
                                                 texture_grads=True)
        grads = worker.flat_grads(g_scene)
        grads.update({f"cam.{k}": g for k, g in g_cam._asdict().items()})
        return loss, grads
    leaves = [x.detach().requires_grad_() for x in sharding._scene_leaves(scene, cam)]
    if route == "replay":
        leaves[-1] = leaves[-1].detach()  # the replay's texture image takes no gradient
    n = len(leaves) - 1
    s = bwd.with_float_leaves(scene, cam, leaves[:n] + list(cam))[0]._replace(textures=leaves[n])
    if route == "remat":
        fb = renderer.render_frame(s, cam, GW, GH, 2, worker.GDEPTH)
    else:
        fb = diff.render_frame_diff(s, cam, GW, GH, 2, worker.GDEPTH, mode="replay")
    loss = torch.mean((fb / 2 - target) ** 2)
    got = iter(torch.autograd.grad(loss, [x for x in leaves if x.requires_grad],
                                   allow_unused=True))
    grads = [next(got) if x.requires_grad else None for x in leaves]
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), worker.flat_grads(sharding._scene_grads(scene, cam, grads))


def _hold(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grads_match_one_device(runs, inputs, world, route):
    loss, grads = _one_device(inputs, route)
    for res in runs[world][1]:
        if route == "deep":
            assert res["deep.loss"] == loss.numpy()  # the frame is bit-equal
        else:
            np.testing.assert_allclose(res[f"{route}.loss"], loss.numpy(), rtol=1e-6)
        for name, want in grads.items():
            _hold(res[f"{route}.{name}"], want.numpy(), name)
    assert np.abs(grads["spheres.center"].numpy()).max() > 0
    if route != "replay":  # the replay's texture image gets no gradient
        assert np.abs(grads["textures"].numpy()).max() > 0


def test_remat_grads_match_tracer_sharded(runs):
    jscene, jcam, target = _jax_grad_inputs()
    mesh = jax_sharding.make_mesh(jax.devices()[:8])
    loss, g = jax_sharding.scene_grads_sharded(jscene, jcam, target, GW, GH, 2, worker.GDEPTH,
                                               mesh)
    res = runs[2][1][0]
    np.testing.assert_allclose(res["remat.loss"], float(loss), rtol=1e-6)
    want = {f"{grp}.{name}": x for grp in ("spheres", "planes", "materials")
            for name, x in getattr(g, grp)._asdict().items()
            if jnp.issubdtype(x.dtype, jnp.floating)}
    want["textures"] = g.textures
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(res[f"remat.{name}"], w, rtol=1e-4,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())), err_msg=name)


def _single_animation(tmp_path):
    scene, params = worker.anim_setup(str(tmp_path / "frame_%d.bin"))
    fb = driver.render_animation(scene, params, engine="torch", out=io.StringIO())
    return fb, [image_io.read_binary(str(tmp_path / f"frame_{n}.bin")) for n in range(3)]


def _tsv_frames(path):
    lines = path.read_text().splitlines()
    for line in lines:
        assert line.split("\t")[2] == str(W * H * 4)
    return [int(line.split("\t")[0]) for line in lines]


def _written(out_dir, mode, rank, files):
    """The frames a rank wrote (into its own directory), each checked
    bit-equal to the one-process file."""
    own = out_dir / mode / f"rank{rank}"
    frames = sorted(int(f[len("frame_"):-len(".bin")]) for f in os.listdir(own))
    for n in frames:
        np.testing.assert_array_equal(image_io.read_binary(str(own / f"frame_{n}.bin")),
                                      files[n])
    return frames


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_row_sharded_animation_writes_from_rank_0_only(runs, world, tmp_path):
    fb, files = _single_animation(tmp_path)
    out_dir, res = runs[world]
    assert _written(out_dir, "rows", 0, files) == [0, 1, 2]
    assert _tsv_frames(out_dir / "rows_0.tsv") == [0, 1, 2]
    for rank in range(world):
        np.testing.assert_array_equal(res[rank]["rows.fb"], fb)
        if rank:
            assert _written(out_dir, "rows", rank, files) == []
            assert (out_dir / f"rows_{rank}.tsv").read_text() == ""


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_frame_sharded_animation_splits_frames(runs, world, tmp_path):
    _, files = _single_animation(tmp_path)
    out_dir, _ = runs[world]
    for rank in range(world):
        mine = list(range(rank, 3, world))
        assert _written(out_dir, "frames", rank, files) == mine
        assert _tsv_frames(out_dir / f"frames_{rank}.tsv") == mine


def test_my_frames_round_robin():
    assert multihost.my_frames(10, 1, 3) == [1, 4, 7]
    assert multihost.my_frames(3, 0, 4) == [0]
    assert multihost.my_frames(3, 3, 4) == []
    assert not dist.is_initialized()
    assert multihost.my_frames(3) == [0, 1, 2]  # no group: one process has every frame


def test_initialize_is_a_no_op_for_one_process():
    assert multihost.initialize(num_processes=1) is False
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("127.0.0.1:1", 2, 0, backend="mpi")
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize(num_processes=2, process_id=0)


def test_initialize_raises_when_the_group_does_not_come_together():
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="[Tt]ime"):
        multihost.initialize(f"127.0.0.1:{_free_ports(1)[0]}", 2, 0, backend="gloo",
                             timeout=3)
    assert time.perf_counter() - t0 < 60
    assert not dist.is_initialized()


def test_dryrun_on_two_ranks(runs):
    res = runs[2][1]
    keys = [k for k in res[0] if k.startswith("dryrun.")]
    assert len(keys) == 3
    for k in keys:
        assert np.isfinite(res[0][k]) and res[0][k] > 0 and res[0][k] == res[1][k]


def test_dist_imports_neither_jax_nor_tracer():
    code = ("import sys\n"
            "import tracer_torch.dist.sharding, tracer_torch.dist.multihost, "
            "tracer_torch.dist.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tracer'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       env=SUB_ENV, timeout=240)
    assert r.returncode == 0, r.stderr


def test_dist_smoke_on_two_cpu_ranks(tmp_path):
    """dist_smoke.py (the multi-card check) under torchrun with gloo: the
    sharded frame and d50 step held against one device on every rank."""
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                        "--nproc_per_node=2", os.path.join(REPO, "dist_smoke.py"), "--cpu"],
                       capture_output=True, text=True, cwd=tmp_path, env=SUB_ENV, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["ranks"] == 2 and res["ranks_failed"] == 0
    assert res["frame_bit_equal"] and res["loss_bit_equal"] and res["grad_worst_rel"] <= 1e-5
