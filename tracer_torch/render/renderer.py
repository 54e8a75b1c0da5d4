"""Frame renderer: the plain PyTorch version of the CUDA megakernel (port
of tracer.render.renderer; reference `render_kernel`, src/camera.cu:17-34).

Pixels are processed in fixed chunks (bounding the dense `[chunk, prims]`
intersection temporaries) and samples accumulate per chunk. The
framebuffer holds RAW sample sums (un-averaged), exactly like the
reference (camera.cu:33); savers divide.
"""

from __future__ import annotations

import torch

from tracer_torch.core import rng
from tracer_torch.render import camera as camera_mod
from tracer_torch.render import integrator
from tracer_torch.scene.types import Scene

DEFAULT_CHUNK = 16384


def render_pixels(scene: Scene, cam: camera_mod.CameraData, i_flat, j_flat, base_seed,
                  spp: int, max_depth: int, chunk: int = DEFAULT_CHUNK,
                  sample_start: int = 0, rr_start=None):
    """Raw sample sums `[N, 3]` for a flat list of pixels.

    i_flat/j_flat: `[N]` pixel column/row; base_seed: `[N]` per-pixel seed
    (int64 holding uint32). Samples are the global ids
    `sample_start .. sample_start + spp - 1`, so chunked calls add up to
    the one-shot frame.
    """
    out = []
    for c0 in range(0, i_flat.shape[0], chunk):
        i, j, base = i_flat[c0:c0 + chunk], j_flat[c0:c0 + chunk], base_seed[c0:c0 + chunk]
        acc = torch.zeros((i.shape[0], 3), dtype=torch.float32, device=i.device)
        for s in range(sample_start, sample_start + spp):
            seed = rng.sample_seed(base, s)
            seed, origin, direction = camera_mod.get_rays(cam, i, j, seed)
            color, _ = integrator.trace(scene, cam.background, origin, direction, seed,
                                        max_depth, rr_start=rr_start)
            acc = acc + color
        out.append(acc)
    return torch.cat(out, dim=0)


def pixel_grid(width: int, height: int, reference_quirk: bool = True, device="cpu"):
    """Flat pixel index tensors (i=column, j=row, row-major) and per-pixel
    base seeds (camera.cu:25, with or without the i*width+j quirk)."""
    jj, ii = torch.meshgrid(
        torch.arange(height, dtype=torch.int64, device=device),
        torch.arange(width, dtype=torch.int64, device=device),
        indexing="ij",
    )
    i_flat, j_flat = ii.reshape(-1), jj.reshape(-1)
    return i_flat, j_flat, rng.pixel_seed(i_flat, j_flat, width, reference_quirk)


def render_frame(scene: Scene, cam: camera_mod.CameraData, width: int, height: int,
                 spp: int, max_depth: int, reference_quirk: bool = True, rr_start=None,
                 sample_start: int = 0):
    """Render one frame on the scene's device; returns `[height, width, 3]`
    raw sample sums of samples `sample_start .. sample_start + spp - 1`.

    rr_start (int, default None = off): throughput Russian roulette from
    that bounce index on (see integrator._bounce)."""
    i_flat, j_flat, base_seed = pixel_grid(width, height, reference_quirk, scene.device)
    fb = render_pixels(scene, cam, i_flat, j_flat, base_seed, spp, max_depth,
                       sample_start=sample_start, rr_start=rr_start)
    return fb.reshape(height, width, 3)


def total_rays(width: int, height: int, sqrt_spp: int) -> int:
    """reference camera.cu:344-345: width*height*sqrt_spp^2."""
    return width * height * sqrt_spp * sqrt_spp
