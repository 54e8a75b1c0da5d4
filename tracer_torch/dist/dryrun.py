"""One sharded render and the three sharded gradient routes on a small
scene, on every rank of a process group (port of __graft_entry__.py:
dryrun_multichip).

    torchrun --nproc_per_node=2 -m tracer_torch.dist.dryrun --cpu   # gloo, CPU
    torchrun --nproc_per_node=N -m tracer_torch.dist.dryrun         # NCCL, a card each

Prints one line per rank with the losses it got.
"""

from __future__ import annotations

import argparse
import io
import math

import torch
import torch.distributed as dist

from tracer_torch.dist import multihost, sharding
from tracer_torch.render import camera as camera_mod
from tracer_torch.scene import builders, config


def dryrun(mesh: sharding.Mesh) -> dict:
    """On the smoke scene at 16x8 (`_small_scene`'s counterpart): the plain
    sharded frame (and on a card the kernel's, which must equal it on
    shape and stay finite), then `scene_grads_sharded`,
    `scene_grads_replay_sharded` and `l2_grads_deep_sharded` toward a
    black target. Raises on a misshapen or non-finite result; returns the
    three losses."""
    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    scene = builders.create_scene(params, texture_loader=lambda _: None, device=mesh.device)
    lookfrom, lookat = camera_mod.camera_path_position(params.camera_path, 0, 1,
                                                       device=mesh.device)
    w, h = 16, 8
    cam = camera_mod.build_camera_data(lookfrom, lookat, w, h, params.fov_degrees,
                                       device=mesh.device)

    def finite(name, *ts):
        if not all(bool(torch.isfinite(t).all()) for t in ts):
            raise RuntimeError(f"dryrun: {name} is not finite on rank {mesh.rank}")

    frames = [sharding.render_frame_sharded(scene, cam, w, h, 1, 3, mesh, chunk=64)]
    if mesh.device.type == "cuda":
        frames.append(sharding.render_frame_kernel_sharded(scene, cam, w, h, 1, 3, mesh))
    for fb in frames:
        if tuple(fb.shape) != (h, w, 3):
            raise RuntimeError(f"dryrun: frame of shape {tuple(fb.shape)}, not {(h, w, 3)}")
        finite("the sharded frame", fb)

    target = torch.zeros((h, w, 3), dtype=torch.float32, device=mesh.device)
    losses = {}
    loss, g = sharding.scene_grads_sharded(scene, cam, target, w, h, 1, 3, mesh)
    finite("scene_grads_sharded", loss, g.materials.albedo)
    losses["scene_grads_sharded"] = float(loss)
    loss, g = sharding.scene_grads_replay_sharded(scene, cam, target, w, h, 1, 3, mesh)
    finite("scene_grads_replay_sharded", loss, g.materials.albedo)
    losses["scene_grads_replay_sharded"] = float(loss)
    loss, g, _ = sharding.l2_grads_deep_sharded(scene, cam, target, w, h, 2, 3, mesh,
                                                spp_chunk=1)
    finite("l2_grads_deep_sharded", loss, g.materials.albedo)
    losses["l2_grads_deep_sharded"] = float(loss)
    if not all(math.isfinite(x) and x > 0 for x in losses.values()):
        raise RuntimeError(f"dryrun: losses {losses}")
    return losses


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tracer_torch.dist.dryrun", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cpu", action="store_true", help="gloo on the CPU (default: NCCL on cards)")
    args = p.parse_args(argv)
    if not multihost.initialize(backend="gloo" if args.cpu else "nccl"):
        p.error("needs 2 or more processes: run it under torchrun --nproc_per_node=N")
    try:
        mesh = sharding.make_mesh("cpu" if args.cpu else None)
        print(f"rank {mesh.rank}/{mesh.size} on {mesh.device}: {dryrun(mesh)}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
