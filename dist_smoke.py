#!/usr/bin/env python3
"""The sharded paths of tracer_torch.dist on every rank of a process group,
held against one device, and timed.

    torchrun --nproc_per_node=4 dist_smoke.py         # NCCL, one card a rank
    torchrun --nproc_per_node=4 dist_smoke.py --cpu   # gloo on the CPU, small shapes

Every rank holds the canonical scene (synthetic 1330x2000 floor, as
chip_smoke.py) on its own device and checks, against its own one-device
references:

- the sharded frame (render_frame_kernel_sharded; with --cpu the plain
  render_frame_sharded) bit-equal to one launch of the whole frame;
- l2_grads_deep_sharded(texture_grads=True) against l2_grads_deep: the loss
  bit-equal, every scene and camera leaf and the texture within 1e-4 of its
  max|g| (the backward kernel adds with atomics).

On the card it also times, all ranks from a barrier, host clock to
synchronize, best of 5 after a warm-up: the sharded frame, one launch of
the whole frame on each rank (its own card), the NCCL all_reduce of the
frame alone, and the sharded d50 gradient step beside the one-device step.
Rank 0 prints the card's name and power limit, then one JSON line of the
results. Any failed check exits 1.
"""

from __future__ import annotations

import argparse
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOL_GRAD = 1e-4


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cpu", action="store_true", help="gloo on the CPU at small shapes")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from tracer_torch.dist import multihost, sharding
    from tracer_torch.kernels import bwd
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.scene import builders, config

    if not args.cpu and not torch.cuda.is_available():
        print("dist_smoke: no CUDA device (pass --cpu to run on the CPU)", file=sys.stderr)
        return 1
    if not multihost.initialize(backend="gloo" if args.cpu else "nccl", timeout=300):
        print("dist_smoke: run it under torchrun with 2 or more processes", file=sys.stderr)
        return 1
    try:
        mesh = sharding.make_mesh("cpu" if args.cpu else None)
        dev = mesh.device
        if args.cpu:
            torch.set_num_threads(1)
            frame, grad = (24, 16, 4, 3), (16, 12, 4, 3, 2)
        else:
            frame, grad = (1080, 720, 16, 50), (800, 600, 32, 50, 8)
        params = config.read_scene_params(io.StringIO(config.default_config_text()))
        floor = np.random.default_rng(0).uniform(0.1, 1.0, size=(1330, 2000, 3)).astype(np.float32)
        scene = builders.create_scene(params, texture_loader=lambda _: floor, device=dev)
        cam_at = lambda w, h, n: C.camera_at(params.camera_path, n, params.num_frames, w, h,
                                             params.fov_degrees, device=dev)
        sync = (lambda: None) if args.cpu else torch.cuda.synchronize

        def host_best(fn, reps=5, barrier=True):
            fn()
            best = math.inf
            for _ in range(reps):
                if barrier:
                    dist.barrier()
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                best = min(best, (time.perf_counter() - t0) * 1e3)
            return best

        res = dict(ranks=mesh.size, backend=dist.get_backend(), device=str(dev))
        w, h, spp, d = frame
        cam = cam_at(w, h, 1)
        sharded = (sharding.render_frame_sharded if args.cpu
                   else sharding.render_frame_kernel_sharded)
        got = sharded(scene, cam, w, h, spp, d, mesh)
        want = mk.render_frame_kernel(scene, cam, w, h, spp, d)
        sync()
        res["frame_bit_equal"] = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))

        gw, gh, gspp, gd, chunk = grad
        cam_g = cam_at(gw, gh, 0)
        truth = scene._replace(materials=scene.materials._replace(
            albedo=scene.materials.albedo * 0.85))
        target = mk.render_frame_kernel(truth, cam_g, gw, gh, gspp, gd) / gspp
        step = lambda f, *m: f(scene, cam_g, target, gw, gh, gspp, gd, *m, spp_chunk=chunk,
                               texture_grads=True)
        l1, gs1, gc1 = step(sharding.l2_grads_deep_sharded, mesh)
        l0, gs0, gc0 = step(bwd.l2_grads_deep)
        res["loss_bit_equal"] = bool(torch.equal(l1.view(torch.int32), l0.view(torch.int32)))
        worst = 0.0
        for a, b in zip(bwd.float_grads(scene, gs1, gc1) + [gs1.textures],
                        bwd.float_grads(scene, gs0, gc0) + [gs0.textures]):
            scale = float(b.abs().max())
            worst = max(worst, float((a - b).abs().max()) / scale if scale else 0.0)
        res["grad_worst_rel"] = worst
        del gs1, gc1, gs0, gc0

        if not args.cpu:
            buf = torch.zeros((h, w, 3), device=dev)
            res.update(
                frame=f"canonical {w}x{h} spp{spp} d{d} textured",
                sharded_frame_ms=host_best(lambda: sharded(scene, cam, w, h, spp, d, mesh)),
                one_launch_ms=host_best(lambda: mk.render_frame_kernel(scene, cam, w, h, spp, d)),
                all_reduce_ms=host_best(lambda: dist.all_reduce(buf)),
                step=f"l2_grads_deep, canonical {gw}x{gh} spp{gspp} d{gd} textured, chunks of "
                     f"{chunk}, texture grads",
                sharded_step_ms=host_best(lambda: step(sharding.l2_grads_deep_sharded, mesh),
                                          reps=3),
                one_device_step_ms=host_best(lambda: step(bwd.l2_grads_deep), reps=3))
        ok = res["frame_bit_equal"] and res["loss_bit_equal"] and worst <= TOL_GRAD
        flags = torch.tensor([0 if ok else 1], device=dev)
        dist.all_reduce(flags)
        if mesh.rank == 0:
            if not args.cpu:
                print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True, text=True,
                                     timeout=60).stdout.strip().splitlines()[0])
            res["ranks_failed"] = int(flags)
            print(json.dumps(res), flush=True)
        return 0 if int(flags) == 0 else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
