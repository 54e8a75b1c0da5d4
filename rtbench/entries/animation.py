"""Entry adapter for `tracer_torch.render.driver.render_animation`: frames
rendered back to back in a closed loop, as a user renders an animation.

The traffic file gives the driver's arguments (`intersector`, `spp_chunk`,
`saver`, `saver_spp_quirk`) and `ranks`: with more than one, every frame
is rendered by row bands across that many ranks (`render_animation(mesh=
...)`), one process and one card a rank. This process is rank 0; it starts
the others and prints the result.

A run: inputs from the seed, the program's scene, one launch of the cell's
own shape and the writer as warm-up, then the window: `render_animation`
over a frame iterator that hands out frames 0, 1, ... in path order until
`seconds` have passed since the window's start (rank 0 decides; the others
follow by a broadcast before each frame, so that no rank waits alone in a
frame's all_reduce). The window ends when `render_animation` returns, after
its writer has drained. With `trace` the program's spans are on from the
start of set-up (`profiling.set_spans`; untraced runs keep them off), the
window runs under the profiler, and afterwards the counted kernels count
the launches of the window's first COUNT_FRAMES frames again (the counted
instantiation runs several times slower than the timed one); the
rooflines read those frames' own launches in the trace, the span metrics
the spans that ended before the window and the window's spans in the trace
(rtbench/harness/spans.py).
"""

from __future__ import annotations

import io
import os
import shutil
import socket
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from rtbench.harness import ranks, spans, spec, trace

FWD_KERNEL = "trace_kernel"  # the forward kernels' name (megakernel.cu), in the trace
COUNT_FRAMES = 3


class Outcome(NamedTuple):
    """What rank 0 hands the harness after the window."""
    end_to_end: dict  # metric name -> value, host clock
    frames: list  # frame indices rendered in the window, in order
    files: dict  # frame index -> the file the writer wrote
    last_fb: np.ndarray  # the last frame's raw sums, as render_animation returned them
    inputs: dict  # what both sides were given
    memory_peak_bytes: int  # the fullest rank's peak
    readings: dict  # what the per-layer metrics read (traced runs)
    forbidden: list  # modules of another package loaded in any rank
    frame_ms: list  # the driver's own per-frame times (its TSV), rank 0
    saver_divisor: int


def out_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "rtbench_frames")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(ctx) -> Outcome:
    world = int(ctx.workload.traffic.get("ranks", 1))
    if world == 1:
        return rank_main(ctx, 0, 1, None)
    port = _free_port()
    procs = ranks.start(ctx, world, port)
    try:
        return rank_main(ctx, 0, world, port)
    finally:
        ranks.join(procs)


def rank_main(ctx, rank: int, world: int, port):
    """One rank's run; rank 0 returns the Outcome, the others None."""
    from tracer_torch.kernels import megakernel
    from tracer_torch.render import camera as camera_mod
    from tracer_torch.render import driver
    from tracer_torch.utils import profiling

    for patch in ctx.patches:
        ranks.call(patch)
    wl, tr = ctx.workload, ctx.workload.traffic
    device = torch.device(ctx.device, rank) if ctx.device == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = None
    if world > 1:
        import torch.distributed as dist
        from tracer_torch.dist import sharding

        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
        mesh = sharding.make_mesh(device)
    try:
        profiling.set_spans(ctx.trace)
        kind = spec.scene_kind(wl.config["scene"])
        inp = kind.inputs(wl.config, ctx.seed, device)
        intersector = tr.get("intersector", "brute")
        scene, params = kind.program(inp, wl.config, device, with_bvh=intersector == "bvh")
        folder = out_dir()
        if rank == 0:
            shutil.rmtree(folder, ignore_errors=True)
            os.makedirs(folder)
        params.output_path = os.path.join(folder, "frame_%d.bin")
        w, h = params.width, params.height
        sqrt_spp, depth = params.render.sqrt_rays_per_pixel, params.render.max_depth
        spp = sqrt_spp * sqrt_spp
        chunk = tr.get("spp_chunk") or max(1, driver.MAX_RAYS_PER_LAUNCH // (w * h))
        row0, rows = (0, h) if mesh is None else sharding.row_band(h, world, rank)
        opts = dict(intersector=intersector)

        # warm-up: the writer, one launch of the cell's shape, the collectives
        driver.frame_writer(tr["saver"]).close()
        cam0 = camera_mod.camera_at(params.camera_path, 0, params.num_frames, w, h,
                                    params.fov_degrees, device=device)
        if rows:
            megakernel.render_frame_kernel(scene, cam0, w, rows, min(chunk, spp), depth,
                                           row_offset=row0, **opts)
        if mesh is not None:
            dist.all_reduce(torch.zeros((h, w, 3), device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

        done = []

        def frames():
            n = 0
            while True:
                go = n == 0 or time.perf_counter() - t_start < ctx.seconds
                if mesh is not None:
                    flag = torch.tensor([float(go)], device=device)
                    dist.broadcast(flag, 0)
                    go = bool(flag.item())
                if not go:
                    return
                done.append(n % params.num_frames)
                yield done[-1]
                n += 1

        if mesh is not None:
            dist.barrier()
        tsv = io.StringIO()
        with trace.profiled(ctx.trace, tag=str(rank)) as red:
            t_start = time.perf_counter()
            with trace.window_span():
                fb = driver.render_animation(
                    scene, params, saver=tr["saver"], out=tsv, frames=frames(),
                    engine=ctx.engine, saver_spp_quirk=tr.get("saver_spp_quirk", True),
                    spp_chunk=tr.get("spp_chunk"), mesh=mesh, **opts)
            t_end = time.perf_counter()
        taken = profiling.take_spans()
        window_s = t_end - t_start
        peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0

        mine = {"memory_peak_bytes": peak, "forbidden": ranks.forbidden_modules()}
        if ctx.trace:
            r = red[0]
            counted = done[:COUNT_FRAMES]
            fwd = sorted(iv for name, ivs in r.launches.items() if FWD_KERNEL in name
                         for iv in ivs)[:len(counted) * -(-spp // chunk)]
            work = None
            if device.type == "cuda" and rows:
                sums = np.zeros(len(megakernel.COUNT_NAMES), np.int64)
                for n in counted:
                    cam = camera_mod.camera_at(params.camera_path, n, params.num_frames, w, h,
                                               params.fov_degrees, device=device)
                    for c0 in range(0, spp, chunk):
                        lw = megakernel.loop_work(scene, cam, w, rows, min(chunk, spp - c0),
                                                  depth, sample_start=c0, row_offset=row0, **opts)
                        sums += np.array(lw, np.int64)
                work = dict(zip(megakernel.COUNT_NAMES, (int(x) for x in sums)))
            bvh_records = 0 if scene.bvh is None else int((scene.bvh.left >= 0).sum()) + 1
            mine.update(
                busy_s=r.busy_s, window_s=r.window_s, device_events=r.device_events,
                fwd_kernel_s=sum(s for name, (s, _n) in r.kernels.items() if FWD_KERNEL in name),
                counted_kernel_s=sum(b - a for a, b in fwd),
                counted_span_s=fwd[-1][1] if fwd else 0.0,
                setup_spans=spans.setup(taken, ctx.t0, t_start), setup_total_s=t_start - ctx.t0,
                spans=r.spans, idle_by_span=r.idle_by_span, span_kernels=r.span_kernels,
                breakdown=trace.breakdown(r) if rank == 0 else None, work=work,
                facts=dict(num_spheres=scene.num_spheres, num_planes=scene.num_planes,
                           texels=0 if scene.textures is None else int(scene.textures.numel() // 3),
                           bvh_records=bvh_records, width=w, rows=rows, frames=len(counted)))
        everyone = [mine]
        if mesh is not None:
            everyone = [None] * world
            dist.all_gather_object(everyone, mine)
        if rank != 0:
            return None
        rays = len(done) * w * h * spp
        readings = {"chips": world, "window_s": window_s}
        if ctx.trace:
            readings["ranks"] = everyone
            readings["breakdown"] = mine["breakdown"]
        return Outcome(
            end_to_end={"mrays_per_s": rays / window_s / 1e6, "setup_s": t_start - ctx.t0},
            frames=list(done),
            files={n: params.output_path % n for n in done},
            last_fb=fb,
            inputs=inp,
            memory_peak_bytes=max(m["memory_peak_bytes"] for m in everyone),
            readings=readings,
            forbidden=sorted({x for m in everyone for x in m["forbidden"]}),
            frame_ms=[float(line.split("\t")[1]) for line in tsv.getvalue().splitlines()],
            saver_divisor=sqrt_spp if tr.get("saver_spp_quirk", True) else spp)
    finally:
        profiling.set_spans(False)
        profiling.take_spans()
        if mesh is not None:
            dist.destroy_process_group()
