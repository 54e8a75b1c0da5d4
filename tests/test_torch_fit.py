"""tracer_torch.opt.fit and the `--fit` CLI against tracer.opt.fit, on the
CPU, on tests/test_opt.py's scene (12x8, spp 2, depth 3).

Engine "torch" (autograd through the plain renderer) against JAX's
"xla": per-step losses within a relative 1e-4 and fitted parameters
within atol 1e-4 at lr 1e-2. Adam's first steps move each component by
about lr times the sign of its gradient, so the parameters agree as long
as no gradient component is near rounding: the albedos of the lit
materials have gradients far above it, and the other fitted components
(the light's albedo, the sphere centres of this Lambertian scene) have
none in either package. A JAX checkpoint resumed by the port takes the same next steps
as JAX resuming it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tracer.opt import fit as jax_fit
from tracer_torch import cli
from tracer_torch.io import image as image_io
from tracer_torch.opt import fit
from tracer_torch.render import camera
from tracer_torch.scene import types as T

sys.path.insert(0, os.path.dirname(__file__))
import test_opt  # noqa: E402
from test_torch_driver import SUB_ENV, _small_config  # noqa: E402
from test_torch_scene import jax_cam_fields, jax_scene_fields  # noqa: E402
from torch_scenes import one_torch_thread  # noqa: E402,F401

W, H, SPP, DEPTH = test_opt.W, test_opt.H, test_opt.SPP, test_opt.DEPTH
PATHS = ("materials.albedo", "spheres.center")
LR = 1e-2


def _port(jscene):
    return T.scene_from_numpy(jax_scene_fields(jscene), "cpu")


def _pcam():
    return camera.camera_from_numpy(jax_cam_fields(test_opt._cam()), "cpu")


@pytest.fixture(scope="module")
def target():
    return test_opt._target(test_opt._scene(albedo0=(0.2, 0.8, 0.4)))


def _kw(**over):
    kw = dict(spp=SPP, max_depth=DEPTH, param_paths=PATHS, learning_rate=LR, log_every=0)
    kw.update(over)
    return kw


def _assert_params(fitted, jfitted):
    for path in PATHS:
        np.testing.assert_allclose(fit.get_path(fitted, path).numpy(),
                                   np.asarray(jax_fit.get_path(jfitted, path)), atol=1e-4)


def test_fit_matches_jax(target):
    init = test_opt._scene(albedo0=(0.5, 0.5, 0.5))
    jfitted, jlosses = jax_fit.fit(init, test_opt._cam(), target, W, H, steps=3, **_kw())
    fitted, losses = fit.fit(_port(init), _pcam(), target, W, H, steps=3, engine="torch",
                             **_kw())
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    _assert_params(fitted, jfitted)
    # the lit materials' albedos took steps; the centres' straight-through
    # gradients are exactly 0 in this all-Lambertian scene, in both packages
    moved = (fitted.materials.albedo - _port(init).materials.albedo)[:2]
    assert float(moved.abs().min()) > 0.1 * LR


def test_resume_from_a_jax_checkpoint(target, tmp_path):
    init = test_opt._scene(albedo0=(0.5, 0.5, 0.5))
    ck_j, ck_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jax_fit.fit(init, test_opt._cam(), target, W, H, steps=2, checkpoint_path=ck_j,
                checkpoint_every=100, **_kw())
    with open(ck_j, "rb") as src, open(ck_t, "wb") as dst:
        dst.write(src.read())
    jfitted, jlosses = jax_fit.fit(init, test_opt._cam(), target, W, H, steps=4,
                                   checkpoint_path=ck_j, checkpoint_every=100, **_kw())
    logs = []
    fitted, losses = fit.fit(_port(init), _pcam(), target, W, H, steps=4, engine="torch",
                             checkpoint_path=ck_t, checkpoint_every=100, log=logs.append,
                             **_kw())
    assert logs == [f"resumed from {ck_t} at step 2"] and len(losses) == 2
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    _assert_params(fitted, jfitted)
    # the port's checkpoint has JAX's layout: JAX resumes it too
    with np.load(ck_t) as a, np.load(ck_j) as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(a["step"]) == int(b["step"]) == 4 and int(a["opt:0"]) == int(b["opt:0"]) == 4
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=k)


def test_port_checkpoint_resume_is_exact(target, tmp_path):
    init = _port(test_opt._scene(albedo0=(0.5, 0.5, 0.5)))
    full, _ = fit.fit(init, _pcam(), target, W, H, steps=4, engine="torch", **_kw())
    ck = str(tmp_path / "fit.npz")
    fit.fit(init, _pcam(), target, W, H, steps=2, engine="torch", checkpoint_path=ck,
            checkpoint_every=100, **_kw())
    resumed, _ = fit.fit(init, _pcam(), target, W, H, steps=4, engine="torch",
                         checkpoint_path=ck, checkpoint_every=100, log=lambda _m: None, **_kw())
    for path in PATHS:
        torch.testing.assert_close(fit.get_path(resumed, path), fit.get_path(full, path),
                                   rtol=1e-6, atol=1e-7)


def test_camera_fit_matches_jax(target):
    scene = test_opt._scene(albedo0=(0.2, 0.8, 0.4))
    spec = dict(origin=[4.06, -3.95, 2.54], look_at=[0.0, 0.0, 1.0], vfov=60.0,
                background=(0.1, 0.1, 0.2))
    kw = dict(spp=SPP, max_depth=DEPTH, param_paths=("camera.origin",), learning_rate=1e-3,
              log_every=0, steps=2)
    _, jlosses, jspec = jax_fit.fit(scene, test_opt._cam(), target, W, H, cam_spec=spec, **kw)
    _, losses, got = fit.fit(_port(scene), _pcam(), target, W, H, cam_spec=spec,
                             engine="torch", **kw)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(got["origin"].numpy(), np.asarray(jspec["origin"]), atol=1e-5)


def test_path_helpers_and_engine_checks(target):
    scene = _port(test_opt._scene())
    v = fit.get_path(scene, "materials.albedo")
    twice = fit.set_path(scene, "materials.albedo", v * 2)
    torch.testing.assert_close(twice.materials.albedo, v * 2)
    assert twice.spheres.center is scene.spheres.center
    with pytest.raises(ValueError, match="CUDA device"):
        fit.fit(scene, _pcam(), target, W, H, steps=1, engine="cuda", **_kw())
    with pytest.raises(ValueError, match="unknown engine"):
        fit.fit(scene, _pcam(), target, W, H, steps=1, engine="xla", **_kw())
    with pytest.raises(ValueError, match="cam_spec"):
        fit.fit(scene, _pcam(), target, W, H, steps=1, engine="torch",
                **_kw(param_paths=("camera.origin",)))


def _cli_target(tmp_path):
    """A target frame rendered by the port's CLI (smoke config, 48x32)."""
    cfg = _small_config(tmp_path)
    assert cli.main(["--cpu", "--config", str(cfg), "--frames", "1"]) == 0
    return cfg, tmp_path / "out_0.bin"


def test_cli_fit_on_the_cpu(tmp_path, capsys):
    cfg, tgt = _cli_target(tmp_path)
    capsys.readouterr()
    ck = tmp_path / "fit.npz"
    argv = ["--cpu", "--config", str(cfg), "--fit", str(tgt), "--fit-params",
            "materials.albedo", "--fit-steps", "2", "--fit-lr", "0.05",
            "--fit-checkpoint", str(ck)]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-2].startswith("materials.albedo = [[") and out[-1].startswith("final loss: ")
    assert np.isfinite(float(out[-1].split(": ")[1]))
    with np.load(ck) as z:
        assert int(z["step"]) == 2 and z["param:materials.albedo"].shape[1] == 3
    assert image_io.read_binary(str(tgt)).shape == (32, 48, 3)


def test_cli_fit_rejects_a_target_of_another_size(tmp_path, capsys):
    cfg, tgt = _cli_target(tmp_path)
    image_io.SAVERS["bin"](str(tgt), np.zeros((8, 8, 3), np.float32), 1)
    assert cli.main(["--cpu", "--config", str(cfg), "--fit", str(tgt)]) == 2
    assert "target is 8x8, config says 48x32" in capsys.readouterr().err


def test_cli_fit_needs_cuda_without_cpu_flag(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, tgt = _cli_target(tmp_path)
    assert cli.main(["--config", str(cfg), "--fit", str(tgt)]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


def test_cli_fit_subprocess(tmp_path):
    cfg, tgt = _cli_target(tmp_path)
    r = subprocess.run([sys.executable, "-m", "tracer_torch.cli", "--cpu", "--config", str(cfg),
                        "--fit", str(tgt), "--fit-steps", "1"],
                       capture_output=True, text=True, cwd=tmp_path, env=SUB_ENV, timeout=240)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1].startswith("final loss: ")
