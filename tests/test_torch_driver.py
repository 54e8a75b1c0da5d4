"""tracer_torch frame driver and CLI: TSV lines, saved frames, flag
handling, sample chunking, and the package's independence from JAX."""

import io
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from tracer import cli as jax_cli
from tracer_torch import cli
from tracer_torch.io import image as image_io
from tracer_torch.kernels import megakernel
from tracer_torch.render import driver
from tracer_torch.scene import builders, config

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_scene import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# subprocesses get one torch thread too (see one_torch_thread)
SUB_ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
TSV = re.compile(r"^(\d+)\t(\d+(?:\.\d+)?(?:e[-+]?\d+)?)\t(\d+)$")


def _small_config(tmp_path, frames=1):
    """The smoke config at 48x32, sqrt_spp 2, writing into tmp_path."""
    text = config.smoke_config_text()
    text = text.replace("200 100 90", "48 32 90")
    text = text.replace("test_output_%d.png", str(tmp_path / "out_%d.bin"))
    text = text.replace("1\n", f"{frames}\n", 1)
    assert text.endswith("5 2\n")
    path = tmp_path / "cfg.txt"
    path.write_text(text)
    return path


def test_cli_cpu_subprocess_writes_frame_and_tsv(tmp_path):
    cfg = _small_config(tmp_path)
    with open(cfg) as stdin:
        r = subprocess.run(
            [sys.executable, "-m", "tracer_torch.cli", "--cpu", "--format", "bin", "--frames", "1"],
            stdin=stdin, capture_output=True, text=True, cwd=tmp_path, env=SUB_ENV, timeout=300,
        )
    assert r.returncode == 0, r.stderr
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    m = TSV.match(lines[0])
    assert m and m.group(1) == "0" and int(m.group(3)) == 48 * 32 * 4
    img = image_io.read_binary(str(tmp_path / "out_0.bin"))
    assert img.shape == (32, 48, 3) and img.any()


def test_cli_in_process_tsv_per_frame(tmp_path, capsys):
    cfg = _small_config(tmp_path, frames=3)
    assert cli.main(["--cpu", "--config", str(cfg), "--frames", "2", "--rr", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [TSV.match(x).group(1) for x in lines] == ["0", "1"]
    assert sorted(p.name for p in tmp_path.glob("out_*.bin")) == ["out_0.bin", "out_1.bin"]


def test_cli_gpu_without_cuda_fails(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _small_config(tmp_path)
    assert cli.main(["--gpu", "--config", str(cfg)]) != 0
    assert cli.main(["--pallas", "--config", str(cfg)]) != 0
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.glob("out_*"))


@pytest.mark.parametrize("argv", [[], ["--backend", "auto"]], ids=["no-flag", "auto"])
def test_cli_without_device_flag_needs_cuda(argv, tmp_path, capsys):
    """Only --cpu or --backend cpu asks for the twin: otherwise the CLI runs
    on the card, and exits 1 without one, writing no frame."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = _small_config(tmp_path)
    assert cli.main(["--config", str(cfg), *argv]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err
    assert not list(tmp_path.glob("out_*"))
    assert cli.main(["--backend", "cpu", "--config", str(cfg)]) == 0
    assert list(tmp_path.glob("out_*"))


@pytest.mark.parametrize("text", ["", "1\nx.png\n48 32", "1 x.png 48 32 90 oops"])
def test_cli_bad_config_exits_2(text, monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(text))
    assert cli.main(["--cpu"]) == 2
    assert capsys.readouterr().err.startswith("tracer: bad config:")


UNPORTED = [
    ["--bvh"], ["--ref-rng"], ["--stratify"], ["--fast-math"], ["--retries", "2"],
    ["--backend", "tpu"],
]


@pytest.mark.parametrize("argv", UNPORTED, ids=[a[0] for a in UNPORTED])
def test_cli_unported_flag_exits_2(argv, tmp_path, capsys):
    cfg = _small_config(tmp_path)
    assert cli.main(["--cpu", "--config", str(cfg), *argv]) == 2
    assert capsys.readouterr().err.startswith("tracer: not yet ported: " + argv[0])
    assert not list(tmp_path.glob("out_*"))


@pytest.mark.parametrize("flag", ["--default", "--smoke"])
def test_cli_prints_configs_like_tracer(flag, capsys):
    assert cli.main([flag]) == 0
    ours = capsys.readouterr().out
    assert jax_cli.main([flag]) == 0
    assert ours == capsys.readouterr().out


def _scene_and_params(tmp_path, frames=2):
    params = config.read_scene_params(_small_config(tmp_path, frames).read_text())
    return builders.create_scene(params, device="cpu"), params


def test_render_animation_cuda_engine_needs_a_cuda_scene(tmp_path):
    scene, params = _scene_and_params(tmp_path)
    with pytest.raises(ValueError, match="CUDA device"):
        driver.render_animation(scene, params, engine="cuda", out=io.StringIO())
    with pytest.raises(ValueError, match="unknown engine"):
        driver.render_animation(scene, params, engine="pallas", out=io.StringIO())


def test_render_animation_spp_chunks_match_one_call(tmp_path):
    scene, params = _scene_and_params(tmp_path, frames=1)
    out = io.StringIO()
    one = driver.render_animation(scene, params, engine="torch", out=out, frames=[0])
    launches = megakernel.LAUNCHES
    chunked = driver.render_animation(scene, params, engine="torch", out=out, frames=[0],
                                      spp_chunk=1)
    assert megakernel.LAUNCHES == launches
    np.testing.assert_allclose(chunked, one, rtol=1e-5, atol=1e-5)
    assert [TSV.match(x).group(3) for x in out.getvalue().splitlines()] == [str(48 * 32 * 4)] * 2


def test_render_animation_saver_divisor(tmp_path):
    scene, params = _scene_and_params(tmp_path, frames=1)
    fb = driver.render_animation(scene, params, engine="torch", out=io.StringIO())
    img = image_io.read_binary(str(tmp_path / "out_0.bin"))
    np.testing.assert_array_equal(img, image_io.quantize(fb, 2))  # sqrt_spp, the quirk
    driver.render_animation(scene, params, engine="torch", out=io.StringIO(),
                            saver_spp_quirk=False)
    img = image_io.read_binary(str(tmp_path / "out_0.bin"))
    np.testing.assert_array_equal(img, image_io.quantize(fb, 4))


def test_kernel_build_needs_nvcc():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        megakernel.build()
    assert megakernel.library_path().name.startswith("libtracer_megakernel-")


def test_package_imports_neither_jax_nor_tracer():
    code = (
        "import importlib, pkgutil, sys, tracer_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tracer_torch.__path__, 'tracer_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 20, mods\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'tracer'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, env=SUB_ENV, timeout=300)
    assert r.returncode == 0, r.stderr
