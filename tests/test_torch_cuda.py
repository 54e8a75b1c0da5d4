"""The CUDA megakernel against its plain PyTorch version, on a CUDA device.

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

from tracer_torch.kernels import megakernel
from tracer_torch.render import camera, renderer
from tracer_torch.scene import builders, config

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from chip_smoke import SKY, full_scene  # noqa: E402

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
    cpu_cam = camera.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 8, 8, 90.0)
    with pytest.raises(ValueError, match="is on cpu"):
        megakernel.render_frame_kernel(scene, cpu_cam, 8, 8, 1, 2)
    with pytest.raises(ValueError, match="spp must be a positive int"):
        megakernel.render_frame_kernel(scene, cam, 8, 8, 0, 2)
