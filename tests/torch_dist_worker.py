"""One rank of tests/test_torch_dist.py: opens a gloo group on the CPU
through tracer_torch.dist.multihost.initialize, runs every sharded check
on the inputs the test wrote, and saves what it got for the test to
compare. Imports torch, numpy and tracer_torch only (no JAX).

    python tests/torch_dist_worker.py INPUTS.npz OUT_DIR ADDR WORLD RANK
"""

import io
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from tracer_torch.dist import dryrun, multihost, sharding
from tracer_torch.kernels import megakernel
from tracer_torch.render import camera
from tracer_torch.scene import builders, config
from tracer_torch.scene import types as T

SPP, DEPTH = 4, 3  # the frame checks
GSPP, GDEPTH, GCHUNK = 4, 4, 2  # the gradient checks


def anim_setup(out_path):
    """(scene, params) of the multihost checks, on the CPU: the canonical
    config's scene and camera path at 16x7, 3 frames, sqrt_spp 2, depth 3,
    a seeded 8x8 floor texture, writing to `out_path` (with %d)."""
    text = config.default_config_text().replace("100\nimages/render_%d.png\n1080 720 50",
                                                f"3\n{out_path}\n16 7 50")
    params = config.read_scene_params(io.StringIO(text.replace("\n50 50\n", "\n3 2\n")))
    tex = np.random.default_rng(2).uniform(0.1, 1.0, size=(8, 8, 3)).astype(np.float32)
    return builders.create_scene(params, texture_loader=lambda _: tex, device="cpu"), params


def scene_from(inputs, prefix):
    fields = {k[len(prefix):]: v for k, v in inputs.items() if k.startswith(prefix)}
    cam = {k[4:]: v for k, v in fields.items() if k.startswith("cam.")}
    return T.scene_from_numpy(fields, "cpu"), camera.camera_from_numpy(cam, "cpu")


def flat_grads(g_scene):
    """{leaf path: gradient} of a Scene of gradients, its textures included."""
    out = {f"{grp}.{name}": x for grp in ("spheres", "planes", "materials")
           for name, x in getattr(g_scene, grp)._asdict().items() if x is not None}
    if g_scene.textures is not None:
        out["textures"] = g_scene.textures
    return out


def run(inputs, out_dir, world, rank):
    mesh = sharding.make_mesh("cpu")
    assert (mesh.size, mesh.rank, mesh.axis) == (world, rank, "tiles")
    res = {}
    scene, cam = scene_from(inputs, "frame.")
    h, w = inputs["frame.shape"]
    res["frame"] = sharding.render_frame_sharded(scene, cam, w, h, SPP, DEPTH, mesh, chunk=13)
    res["frame_rows"] = sharding._frame_by_bands(megakernel.render_frame_kernel, scene, cam, w,
                                                 h, mesh, spp=SPP, max_depth=DEPTH)
    ref = dict(spp=SPP, max_depth=DEPTH, rng_mode="reference")
    res["frame_ref"] = sharding.render_frame_sharded(scene, cam, w, h, mesh=mesh, chunk=13, **ref)
    res["frame_rows_ref"] = sharding._frame_by_bands(megakernel.render_frame_kernel, scene, cam,
                                                     w, h, mesh, **ref)
    spp_u, spp_s = (4, 4) if world == 2 else (6, 9)
    res["spp_ref"] = sharding.render_frame_spp_sharded(scene, cam, w, h, spp_u, DEPTH, mesh,
                                                       rng_mode="reference")
    res["spp_uniform"] = sharding.render_frame_spp_sharded(scene, cam, w, h, spp_u, DEPTH, mesh)
    res["spp_stratified"] = sharding.render_frame_spp_sharded(scene, cam, w, h, spp_s, DEPTH,
                                                              mesh, stratify=True)

    scene, cam = scene_from(inputs, "grad.")
    h, w = inputs["grad.shape"]
    target = torch.from_numpy(inputs["grad.target"])
    for name, out in (
            ("remat", sharding.scene_grads_sharded(scene, cam, target, w, h, 2, GDEPTH, mesh)),
            ("replay", sharding.scene_grads_replay_sharded(scene, cam, target, w, h, 2, GDEPTH,
                                                           mesh)),
            ("deep", sharding.l2_grads_deep_sharded(scene, cam, target, w, h, GSPP, GDEPTH, mesh,
                                                    spp_chunk=GCHUNK, texture_grads=True))):
        res[f"{name}.loss"] = out[0]
        for k, g in flat_grads(out[1]).items():
            res[f"{name}.{k}"] = g
        if len(out) == 3:
            for k, g in out[2]._asdict().items():
                res[f"{name}.cam.{k}"] = g

    for mode, frame_shard, rng_mode in (("rows", False, "fixed"), ("frames", True, "fixed"),
                                        ("rows_ref", False, "reference")):
        own = os.path.join(out_dir, mode, f"rank{rank}")  # what this rank writes, alone
        os.makedirs(own)
        scene, params = anim_setup(os.path.join(own, "frame_%d.bin"))
        tsv = io.StringIO()
        res[f"{mode}.fb"] = torch.from_numpy(multihost.render_animation_multihost(
            scene, params, frame_shard=frame_shard, engine="torch", out=tsv, rng_mode=rng_mode))
        with open(os.path.join(out_dir, f"{mode}_{rank}.tsv"), "w") as f:
            f.write(tsv.getvalue())

    for k, v in dryrun.dryrun(mesh).items():
        res[f"dryrun.{k}"] = torch.tensor(v)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in res.items()})


def main(argv):
    inputs_path, out_dir, addr, world, rank = argv
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    inputs = dict(np.load(inputs_path))
    if not multihost.initialize(addr, world, rank, backend="gloo", timeout=120):
        raise SystemExit("no process group was opened")
    try:
        run(inputs, out_dir, world, rank)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
