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
from tracer_torch.kernels import cluster as cluster_mod
from tracer_torch.render import camera as camera_mod
from tracer_torch.render import integrator
from tracer_torch.scene.types import Scene

DEFAULT_CHUNK = 16384


def render_pixels(scene: Scene, cam: camera_mod.CameraData, i_flat, j_flat, base_seed,
                  spp: int, max_depth: int, chunk: int = DEFAULT_CHUNK,
                  sample_start: int = 0, rr_start=None, tape_fields=None,
                  cluster_k: int = 0, queries=None):
    """Raw sample sums `[N, 3]` for a flat list of pixels.

    i_flat/j_flat: `[N]` pixel column/row; base_seed: `[N]` per-pixel seed
    (int64 holding uint32). Samples are the global ids
    `sample_start .. sample_start + spp - 1`, so chunked calls add up to
    the one-shot frame. `cluster_k` > 0 takes the cluster-culled nearest
    hit over clusters of at most that many primitives (the plain version
    of the clustered kernel); 0 takes brute force.

    With `tape_fields` (9 or 13) it also records the recording kernel's
    tapes and returns (sums, idx `[spp, max_depth, N]` int32 with -1 for a
    miss or a bounce the path never reached, tex `[spp, max_depth, N, F]`
    or None for an untextured scene); unvisited texture slots hold the
    neutral values (multipliers 1, every other field 0).

    `queries`, a list, receives the nearest-hit query counts of every
    bounce (see `integrator.trace`).
    """
    n, dev = i_flat.shape[0], i_flat.device
    clusters = None
    if cluster_mod.check_k(cluster_k):
        if tape_fields is not None:
            # as tracer's record path, which asserts `not clustered`
            raise ValueError("the recording renderer is brute force only: cluster_k must be 0")
        clusters = cluster_mod.pack_clustered(scene, cluster_k)
    idx = tex = None
    if tape_fields is not None:
        if tape_fields not in integrator.TAPE_FIELDS:
            raise ValueError(f"tape_fields must be one of {integrator.TAPE_FIELDS}, "
                             f"got {tape_fields}")
        idx = torch.full((spp, max_depth, n), -1, dtype=torch.int32, device=dev)
        if scene.textures is not None:
            neutral = torch.tensor(integrator.TAPE_NEUTRAL[:tape_fields], device=dev)
            tex = neutral.expand(spp, max_depth, n, tape_fields).clone()
    out = []
    for c0 in range(0, n, chunk):
        i, j, base = i_flat[c0:c0 + chunk], j_flat[c0:c0 + chunk], base_seed[c0:c0 + chunk]
        c1 = c0 + i.shape[0]
        acc = torch.zeros((i.shape[0], 3), dtype=torch.float32, device=dev)
        for s in range(spp):
            seed = rng.sample_seed(base, sample_start + s)
            seed, origin, direction = camera_mod.get_rays(cam, i, j, seed)
            res = integrator.trace(scene, cam.background, origin, direction, seed, max_depth,
                                   rr_start=rr_start, tape_fields=tape_fields,
                                   clusters=clusters, queries=queries)
            for d, (w, t) in enumerate(res[2] if idx is not None else ()):
                idx[s, d, c0:c1] = w
                if tex is not None:
                    tex[s, d, c0:c1] = t
            acc = acc + res[0]
        out.append(acc)
    sums = torch.cat(out, dim=0)
    return sums if idx is None else (sums, idx, tex)


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
                 sample_start: int = 0, cluster_k: int = 0):
    """Render one frame on the scene's device; returns `[height, width, 3]`
    raw sample sums of samples `sample_start .. sample_start + spp - 1`.

    rr_start (int, default None = off): throughput Russian roulette from
    that bounce index on (see integrator._bounce). cluster_k (int, default
    0 = brute force): the cluster-culled nearest hit over clusters of at
    most that many primitives (see render_pixels)."""
    i_flat, j_flat, base_seed = pixel_grid(width, height, reference_quirk, scene.device)
    fb = render_pixels(scene, cam, i_flat, j_flat, base_seed, spp, max_depth,
                       sample_start=sample_start, rr_start=rr_start, cluster_k=cluster_k)
    return fb.reshape(height, width, 3)


def query_count(scene: Scene, cam: camera_mod.CameraData, width: int, height: int, spp: int,
                max_depth: int, reference_quirk: bool = True, rr_start=None,
                sample_start: int = 0, cluster_k: int = 0) -> int:
    """The nearest-hit queries of `render_frame` with these arguments: one
    per bounce a path starts, its miss included. The plain count beside the
    kernels' counted instantiation (`kernels.megakernel.loop_work`)."""
    i_flat, j_flat, base_seed = pixel_grid(width, height, reference_quirk, scene.device)
    queries = []
    render_pixels(scene, cam, i_flat, j_flat, base_seed, spp, max_depth,
                  sample_start=sample_start, rr_start=rr_start, cluster_k=cluster_k,
                  queries=queries)
    return int(torch.stack(queries).sum())


def total_rays(width: int, height: int, sqrt_spp: int) -> int:
    """reference camera.cu:344-345: width*height*sqrt_spp^2."""
    return width * height * sqrt_spp * sqrt_spp


def render_frame_record(scene: Scene, cam: camera_mod.CameraData, width: int, height: int,
                        spp: int, max_depth: int, reference_quirk: bool = True, rr_start=None,
                        sample_start: int = 0, tape_fields: int = 9):
    """The plain version of the recording kernel (tracer/pallas/megakernel.py:
    render_frame_pallas_record): returns (fb `[H, W, 3]`, idx `[spp, D, H*W]`
    int32) for an untextured scene and (fb, idx, tex `[spp, D, H*W, F]`)
    for a textured one, F = `tape_fields` (9, or 13 with the addressing
    rows the texture-image gradient needs)."""
    i_flat, j_flat, base_seed = pixel_grid(width, height, reference_quirk, scene.device)
    fb, idx, tex = render_pixels(scene, cam, i_flat, j_flat, base_seed, spp, max_depth,
                                 sample_start=sample_start, rr_start=rr_start,
                                 tape_fields=tape_fields)
    fb = fb.reshape(height, width, 3)
    return (fb, idx) if tex is None else (fb, idx, tex)
