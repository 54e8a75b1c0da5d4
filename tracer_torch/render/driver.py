"""Animation frame driver: camera path, per-frame timing TSV, savers (port
of tracer.render.driver; reference `gpu_render` / `cpu_render`,
src/camera.cu:290-394).

A frame loop one frame deep: frame n's camera, its spp chunks (the CUDA
kernel or its plain PyTorch twin) and its copy to the host are enqueued,
and only then is frame n-1 finished: wait for its copy, print the
reference's `frame \\t ms \\t total_rays` TSV line (camera.cu:344-346) and
hand its framebuffer to a background writer: the native C++ writer
(tracer_torch.io.native) for `bin` and `ppm` where g++ can build it, else
io/image.py's ThreadedWriter. So on the card the host's hand-off of a
frame runs while the next frame renders. With a `mesh`
(tracer_torch.dist.sharding) every rank of the group runs the loop, each
frame is rendered across the ranks, and rank 0 alone prints and writes.
With spans on (utils/profiling.set_spans), each frame is the span
`tracer.frame`, holding its `tracer.frame.camera` and the previous frame's
`.sync`, `.fetch` and `.submit` (the last frame's follow the loop), and
the writer's start and drain are `tracer.writer.open` and
`tracer.writer.drain`.
"""

from __future__ import annotations

import sys
import time
from typing import NamedTuple

import torch

from tracer_torch.dist import sharding
from tracer_torch.io import image as image_io
from tracer_torch.io import native as io_native
from tracer_torch.kernels import megakernel
from tracer_torch.render import camera as camera_mod
from tracer_torch.render import integrator, renderer
from tracer_torch.scene.params import SceneParams
from tracer_torch.scene.types import Scene
from tracer_torch.utils import profiling, resilience

ENGINES = ("cuda", "torch")
MAX_RAYS_PER_LAUNCH = 128 * 1024 * 1024
RETRY_BACKOFF_S = 5.0  # the first retry's wait (resilience.retry_transient doubles it)
FRAMES_AHEAD = 0  # frames finished while a later frame's launches were enqueued (since import)


class _Frame(NamedTuple):
    """A frame whose spp chunks and copy to the host are enqueued."""
    n: int
    host: torch.Tensor  # its raw sums on the host, once `done` has fired
    done: object  # the CUDA event after the copy; None on the CPU
    ms: object  # its time in ms on the host clock (CPU), or the CUDA events around its chunks


def frame_writer(saver: str):
    """The background writer for `saver`: the native writer for "bin" and
    "ppm" when it can be built (tracer/render/driver.py:95-104), else
    io/image.py's ThreadedWriter."""
    with profiling.span("tracer.writer.open"):
        if saver in io_native.FORMATS and io_native.available():
            return io_native.AsyncFrameWriter()
        return image_io.ThreadedWriter()


def render_animation(
    scene: Scene,
    params: SceneParams,
    saver: str = "bin",
    out=None,
    reference_quirk: bool = True,
    frames=None,
    engine: str = "cuda",
    saver_spp_quirk: bool = True,
    rr_start=None,
    spp_chunk=None,
    stratify: bool = False,
    intersector: str = "brute",
    mesh=None,
    rng_mode: str = "fixed",
    retries: int = 0,
):
    """Render `params.num_frames` frames (or the indices in `frames`) on the
    scene's device; returns the last framebuffer as a numpy array. The TSV
    lines go to `out` (default: the current sys.stdout), one a frame in
    frame order. A frame's `ms` is its own render time: on the card the
    time between two CUDA events around its spp chunks (a host clock would
    also hold the wait for the frame before it, which renders while the
    host hands that frame on), on the CPU the host clock around them.

    Every frame pulled from `frames` is rendered, printed and written; the
    loop pulls frame n+1 only after frame n-1 is written. Each frame's host
    array is its own (the copy's pinned buffer, never reused while the
    writer may hold it).

    `engine`: "cuda" renders with the CUDA megakernel and requires a scene
    on a CUDA device; "torch" renders with the plain PyTorch twin on the
    scene's device. An unsupported request raises; nothing falls back.

    `spp_chunk`: samples per render call; None bounds each call at
    ~128M rays. The chunks take disjoint global sample ids (`sample_start`),
    so their sum is the one-call frame up to float32 addition order.

    `stratify`: each sample's jitter in its cell of the frame's sqrt_spp x
    sqrt_spp sub-pixel grid. Every chunk takes the whole frame's grid and
    its own `sample_start`, so a chunked stratified frame is the one-call
    frame (chunks need not be square; tracer's driver took the grid from a
    chunk's spp, which asserts on non-square chunks and stratifies square
    ones wrongly).

    `intersector`: "brute" (or "fast") or "bvh" (the scene must carry its
    BVH: builders.create_scene(with_bvh=True)); on engine "cuda", "bvh"
    renders with the BVH kernel.

    `mesh`: a tracer_torch.dist.sharding.Mesh, on the scene's device;
    every rank of its group calls render_animation with the same
    arguments. Each frame is rendered across the ranks: with engine "cuda"
    by row bands (sharding.render_frame_kernel_sharded, brute force only,
    as tracer's), with "torch" by ranges of pixels
    (sharding.render_frame_sharded); every rank gets the whole frame, bit
    for bit the one-device frame, and only rank 0 prints the TSV and
    writes the files. The spp chunks above stay, inside each share.

    `rng_mode`: "fixed" (the 8-draw budget) or "reference" (the reference
    binary's own per-lane stream): engine "cuda" renders it with K1-ref,
    "torch" with the plain renderer (integrator.RNG_MODES); tracer's
    driver drops from its Pallas engine to XLA for it.

    `retries`: each frame is retried up to that many times on a transient
    failure (resilience.retry_transient, RETRY_BACKOFF_S first; a line on
    stderr a retry). A retry renders the whole frame again, every spp chunk
    and the wait for its copy; the failed attempt's chunks are dropped
    first. So with retries > 0 each frame is finished before the next one
    starts, and nothing overlaps. A CUDA error is never retried (a faulted
    context is sticky). With a
    `mesh`, retries > 0 raises ValueError: one rank retrying alone would
    leave the others waiting in the all_reduce of the frame it left.

    `saver_spp_quirk`: the reference drivers build their savers with
    sqrt_rays_per_pixel while accumulating sqrt_spp^2 samples
    (camera.cu:300/357 vs :319-320), so reference image bytes are
    quantize(sum / sqrt_spp). True (default) replicates that for byte
    parity; False divides by the true sample count.
    """
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of {ENGINES}")
    device = scene.device
    if engine == "cuda":
        if device.type != "cuda":
            raise ValueError(f"engine 'cuda' needs a scene on a CUDA device, got {device}")
        render = megakernel.render_frame_kernel
    else:
        render = renderer.render_frame
    if saver not in image_io.SAVERS:
        raise ValueError(f"unknown saver {saver!r}")
    integrator.check_intersector(intersector, scene)
    integrator.check_rng_mode(rng_mode, rr_start)
    if isinstance(retries, bool) or not (isinstance(retries, int) and retries >= 0):
        raise ValueError(f"retries must be an int >= 0, got {retries!r}")
    lead = mesh is None or mesh.rank == 0  # prints the TSV and writes the files
    if mesh is not None:
        if retries:
            raise ValueError("retries > 0 with a mesh: one rank retrying alone would leave the "
                             "others waiting in the frame's all_reduce")
        if engine == "cuda":
            if intersector == "bvh":
                raise ValueError("the sharded kernel path is brute force only, as tracer's")
            render = lambda *a, intersector, **kw: sharding.render_frame_kernel_sharded(
                *a, mesh=mesh, **kw)
        else:
            render = lambda *a, **kw: sharding.render_frame_sharded(*a, mesh=mesh, **kw)

    sqrt_spp = params.render.sqrt_rays_per_pixel
    spp = sqrt_spp * sqrt_spp  # camera.cu:319-320
    saver_divisor = sqrt_spp if saver_spp_quirk else spp
    width, height = params.width, params.height
    rays = renderer.total_rays(width, height, sqrt_spp)
    chunk = spp_chunk or max(1, MAX_RAYS_PER_LAUNCH // (width * height))
    opts = dict(reference_quirk=reference_quirk, rr_start=rr_start, stratify=stratify,
                strat_sqrt_spp=sqrt_spp if stratify else 0, intersector=intersector,
                rng_mode=rng_mode)

    def launch(n, cam):
        """Enqueue frame n's spp chunks and its copy to the host."""
        on_card = device.type == "cuda"
        if on_card:
            stream = torch.cuda.current_stream(device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(stream)
        t0 = time.perf_counter()
        fb_dev = None
        for c0 in range(0, spp, chunk):
            part = render(scene, cam, width, height, min(chunk, spp - c0),
                          params.render.max_depth, sample_start=c0, **opts)
            fb_dev = part if fb_dev is None else fb_dev + part
        if not on_card:
            return _Frame(n, fb_dev, None, (time.perf_counter() - t0) * 1e3)
        end.record(stream)
        # on the stream before the next frame's chunks, into a pinned buffer of its own
        host = fb_dev.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
        return _Frame(n, host, done, (start, end))

    def sync(frame):
        with profiling.span("tracer.frame.sync"):
            if frame.done is not None:
                frame.done.synchronize()
        return frame

    def finish_pending():
        """Wait for the pending frame's copy, print its TSV line and hand it
        to the writer."""
        nonlocal pending, fb
        frame, pending = pending, None
        if not retries:  # with retries its wait was part of its retried call
            sync(frame)
        with profiling.span("tracer.frame.fetch"):
            fb = frame.host.numpy()
        if not lead:
            return
        ms = frame.ms if frame.done is None else frame.ms[0].elapsed_time(frame.ms[1])
        print(f"{frame.n}\t{ms}\t{rays}", file=out)
        try:
            filename = params.output_path % frame.n  # snprintf(path, n), camera.cu:298-300
        except TypeError:
            filename = params.output_path
        with profiling.span("tracer.frame.submit"):
            writer.submit(filename, fb, saver_divisor, fmt=saver)

    global FRAMES_AHEAD
    out = sys.stdout if out is None else out
    writer = frame_writer(saver)
    fb = pending = None  # pending: enqueued, not yet written
    try:
        for n in range(params.num_frames) if frames is None else frames:
            with profiling.span("tracer.frame"):
                with profiling.span("tracer.frame.camera"):
                    cam = camera_mod.camera_at(
                        params.camera_path, n, params.num_frames, width, height,
                        params.fov_degrees, background=(0.0, 0.0, 0.0),  # camera.cu:323
                        device=device)
                if retries:
                    # a failed attempt's chunks live in its frame, which the
                    # traceback holds until retry_transient's handler ends,
                    # before the next attempt starts
                    frame = resilience.retry_transient(
                        lambda: sync(launch(n, cam)), retries=retries,
                        backoff_s=RETRY_BACKOFF_S,
                        on_retry=lambda k, e, n=n: print(
                            f"tracer: frame {n} transient backend failure "
                            f"(retry {k}): {str(e).splitlines()[0][:120]}", file=sys.stderr))
                else:
                    frame = launch(n, cam)
                if pending is not None:  # frame n-1, while frame n renders
                    finish_pending()
                    FRAMES_AHEAD += 1
                pending = frame
                if retries:
                    finish_pending()
        if pending is not None:
            finish_pending()
    except Exception as e:
        # the frame enqueued before a failed one is whole (its copy went on
        # the stream first): write it, as a serial loop would have, unless
        # the card's context is faulted
        if pending is not None and not resilience.is_cuda_fault(e):
            finish_pending()
        raise
    finally:
        # drains the queue and re-raises a write error, and always joins
        with profiling.span("tracer.writer.drain"):
            writer.close()
    return fb
