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
from tracer_torch.kernels import pack
from tracer_torch.render import camera as camera_mod
from tracer_torch.render import integrator
from tracer_torch.scene.types import Scene

DEFAULT_CHUNK = 16384


def render_pixels(scene: Scene, cam: camera_mod.CameraData, i_flat, j_flat, base_seed,
                  spp: int, max_depth: int, chunk: int = DEFAULT_CHUNK,
                  sample_start: int = 0, rr_start=None, tape_fields=None,
                  cluster_k: int = 0, queries=None, stratify: bool = False,
                  strat_sqrt_spp: int = 0, intersector: str = "brute", work=None,
                  rng_mode: str = "fixed"):
    """Raw sample sums `[N, 3]` for a flat list of pixels.

    i_flat/j_flat: `[N]` pixel column/row; base_seed: `[N]` per-pixel seed
    (int64 holding uint32). Samples are the global ids
    `sample_start .. sample_start + spp - 1`, so chunked calls add up to
    the one-shot frame. `cluster_k` > 0 takes the cluster-culled nearest
    hit over clusters of at most that many primitives (the plain version
    of the clustered kernel); else `intersector` picks brute force
    ("brute", "fast") or the BVH ("bvh", the plain version of the BVH
    kernel; `work` as in integrator.trace).

    `stratify=True` confines sample s's jitter to its cell of a k x k
    sub-pixel grid (camera.get_rays), k = sqrt(spp) (spp square) or
    `strat_sqrt_spp`, which a chunk of a larger frame must pass: the
    whole frame's k, with its own `sample_start`.

    With `tape_fields` (0, 3, 9 or 13) it also records the recording
    kernel's tapes and returns (sums, idx `[spp, max_depth, N]` int32 with
    -1 for a miss or a bounce the path never reached, tex `[spp, max_depth,
    N, F]`, or None for an untextured scene or 0 fields); unvisited
    texture slots hold the neutral values (multipliers 1, every other
    field 0).

    `queries`, a list, receives the nearest-hit query counts of every
    bounce (see `integrator.trace`).

    The RTIOW book's estimator (a ThinLensCamera, `scene.sky`, the material
    codes RTIOW_LAMBERTIAN and RTIOW_METAL) renders on the fixed stream
    without tapes: the reference stream and the recording path refuse it.

    `rng_mode`: "fixed" (the 8-draw budget) or "reference" (the reference
    binary's per-lane stream, integrator.RNG_MODES); "reference" refuses
    `rr_start`, `tape_fields` and `cluster_k` > 0 (tracer's clustered path
    is its Pallas kernel, which has no reference stream).
    """
    n, dev = i_flat.shape[0], i_flat.device
    k = camera_mod.strat_grid(stratify, spp, strat_sqrt_spp)
    integrator.check_intersector(intersector, scene)
    integrator.check_rng_mode(rng_mode, rr_start)
    if rng_mode == "reference" or tape_fields is not None:
        unsupported = pack.rtiow_features(scene, cam)
        if unsupported:
            path = "the reference stream" if rng_mode == "reference" else "the recording renderer"
            raise ValueError(f"{path} does not support {', '.join(unsupported)}")
    clusters = None
    if cluster_mod.check_k(cluster_k):
        if rng_mode == "reference":
            raise ValueError("cluster_k > 0 runs the fixed-budget RNG stream only")
        if tape_fields is not None:
            # as tracer's record path, which asserts `not clustered`
            raise ValueError("the recording renderer is brute force only: cluster_k must be 0")
        if intersector == "bvh":
            raise ValueError("intersector 'bvh' and cluster_k > 0 exclude each other")
        clusters = cluster_mod.pack_clustered(scene, cluster_k)
    if intersector == "bvh" and tape_fields is not None:
        # tracer's record path (the Pallas kernel) is brute force only
        raise ValueError("the recording renderer is brute force only: intersector 'bvh'")
    idx = tex = None
    if tape_fields is not None:
        if tape_fields not in integrator.TAPE_FIELDS:
            raise ValueError(f"tape_fields must be one of {integrator.TAPE_FIELDS}, "
                             f"got {tape_fields}")
        idx = torch.full((spp, max_depth, n), -1, dtype=torch.int32, device=dev)
        if scene.textures is not None and tape_fields:
            neutral = torch.tensor(integrator.TAPE_NEUTRAL[:tape_fields], device=dev)
            tex = neutral.expand(spp, max_depth, n, tape_fields).clone()
    out = []
    for c0 in range(0, n, chunk):
        i, j, base = i_flat[c0:c0 + chunk], j_flat[c0:c0 + chunk], base_seed[c0:c0 + chunk]
        c1 = c0 + i.shape[0]
        acc = torch.zeros((i.shape[0], 3), dtype=torch.float32, device=dev)
        for s in range(spp):
            seed = rng.sample_seed(base, sample_start + s)
            seed, origin, direction = camera_mod.get_rays(cam, i, j, seed,
                                                          sample_index=sample_start + s,
                                                          sqrt_spp=k)
            res = integrator.trace(scene, cam.background, origin, direction, seed, max_depth,
                                   rr_start=rr_start, tape_fields=tape_fields,
                                   clusters=clusters, queries=queries, intersector=intersector,
                                   work=work, rng_mode=rng_mode)
            for d, (w, t) in enumerate(res[2] if idx is not None else ()):
                idx[s, d, c0:c1] = w
                if tex is not None:
                    tex[s, d, c0:c1] = t
            acc = acc + res[0]
        out.append(acc)
    sums = torch.cat(out, dim=0)
    return sums if idx is None else (sums, idx, tex)


def pixel_grid(width: int, height: int, reference_quirk: bool = True, *, device,
               row_offset: int = 0):
    """Flat pixel index tensors (i=column, j=row, row-major) on `device` and
    per-pixel base seeds (camera.cu:25, with or without the i*width+j
    quirk), of the `height` image rows starting at `row_offset` (a row band
    of a taller frame keeps the frame's rows in its seeds)."""
    jj, ii = torch.meshgrid(
        torch.arange(row_offset, row_offset + height, dtype=torch.int64, device=device),
        torch.arange(width, dtype=torch.int64, device=device),
        indexing="ij",
    )
    i_flat, j_flat = ii.reshape(-1), jj.reshape(-1)
    return i_flat, j_flat, rng.pixel_seed(i_flat, j_flat, width, reference_quirk)


def render_frame(scene: Scene, cam: camera_mod.CameraData, width: int, height: int,
                 spp: int, max_depth: int, reference_quirk: bool = True, rr_start=None,
                 sample_start: int = 0, cluster_k: int = 0, stratify: bool = False,
                 strat_sqrt_spp: int = 0, intersector: str = "brute", row_offset: int = 0,
                 rng_mode: str = "fixed"):
    """Render one frame on the scene's device; returns `[height, width, 3]`
    raw sample sums of samples `sample_start .. sample_start + spp - 1`
    (with `row_offset`, of the image rows `row_offset .. row_offset +
    height - 1`: a row band, as render_frame_kernel's).

    rr_start (int, default None = off): throughput Russian roulette from
    that bounce index on (see integrator._bounce). cluster_k (int, default
    0 = brute force): the cluster-culled nearest hit over clusters of at
    most that many primitives; intersector: "brute" (or "fast") or "bvh";
    stratify, strat_sqrt_spp: stratified jitter; rng_mode: "fixed" or
    "reference" (see render_pixels)."""
    i_flat, j_flat, base_seed = pixel_grid(width, height, reference_quirk, device=scene.device,
                                           row_offset=row_offset)
    fb = render_pixels(scene, cam, i_flat, j_flat, base_seed, spp, max_depth,
                       sample_start=sample_start, rr_start=rr_start, cluster_k=cluster_k,
                       stratify=stratify, strat_sqrt_spp=strat_sqrt_spp, intersector=intersector,
                       rng_mode=rng_mode)
    return fb.reshape(height, width, 3)


def query_count(scene: Scene, cam: camera_mod.CameraData, width: int, height: int, spp: int,
                max_depth: int, reference_quirk: bool = True, rr_start=None,
                sample_start: int = 0, cluster_k: int = 0, stratify: bool = False,
                strat_sqrt_spp: int = 0, intersector: str = "brute",
                rng_mode: str = "fixed") -> int:
    """The nearest-hit queries of `render_frame` with these arguments: one
    per bounce a path starts, its miss included. The plain count beside the
    kernels' counted instantiation (`kernels.megakernel.loop_work`)."""
    i_flat, j_flat, base_seed = pixel_grid(width, height, reference_quirk, device=scene.device)
    queries = []
    render_pixels(scene, cam, i_flat, j_flat, base_seed, spp, max_depth,
                  sample_start=sample_start, rr_start=rr_start, cluster_k=cluster_k,
                  queries=queries, stratify=stratify, strat_sqrt_spp=strat_sqrt_spp,
                  intersector=intersector, rng_mode=rng_mode)
    return int(torch.stack(queries).sum())


def total_rays(width: int, height: int, sqrt_spp: int) -> int:
    """reference camera.cu:344-345: width*height*sqrt_spp^2."""
    return width * height * sqrt_spp * sqrt_spp


def render_frame_record(scene: Scene, cam: camera_mod.CameraData, width: int, height: int,
                        spp: int, max_depth: int, reference_quirk: bool = True, rr_start=None,
                        sample_start: int = 0, tape_fields: int = 9, stratify: bool = False,
                        strat_sqrt_spp: int = 0, row_offset: int = 0):
    """The plain version of the recording kernel (tracer/pallas/megakernel.py:
    render_frame_pallas_record): returns (fb `[H, W, 3]`, idx `[spp, D, H*W]`
    int32) for an untextured scene and (fb, idx, tex `[spp, D, H*W, F]`)
    for a textured one, F = `tape_fields`: 3 (the texel multipliers,
    what mode "replay" replays), 9 (and their d(texel)/du, d(texel)/dv,
    what the backward kernel linearises) or 13 (and the addressing rows
    the texture-image gradient needs). With 0 it returns (fb, idx) for
    any scene: the index tape alone, what mode "replay-sample" keeps.
    Brute force only, as tracer's recording kernel; stratify as
    render_pixels. With `row_offset` it records the row band of `height`
    rows from that image row: the frame's rows and their tape columns."""
    i_flat, j_flat, base_seed = pixel_grid(width, height, reference_quirk, device=scene.device,
                                           row_offset=row_offset)
    fb, idx, tex = render_pixels(scene, cam, i_flat, j_flat, base_seed, spp, max_depth,
                                 sample_start=sample_start, rr_start=rr_start,
                                 tape_fields=tape_fields, stratify=stratify,
                                 strat_sqrt_spp=strat_sqrt_spp)
    fb = fb.reshape(height, width, 3)
    return (fb, idx) if tex is None else (fb, idx, tex)
