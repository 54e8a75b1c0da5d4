"""Command-line driver of the PyTorch/CUDA port (port of tracer.cli).

Covers the reference CLI (src/main.cu:572-606): with no device flag or
`--gpu` it renders a stdin config with the CUDA megakernel (and exits 1
when there is no CUDA device), `--cpu` with the plain PyTorch twin on the
CPU; `--default` / `--smoke` print the sample configs. `--bvh` renders
through the scene's BVH (the BVH kernel on the card, the plain traversal
with `--cpu`), `--stratify` stratifies the sub-pixel jitter, `--ref-rng`
renders on the reference binary's own RNG stream (the reference-stream
kernel on the card, the plain renderer with `--cpu`), `--retries N`
retries each frame up to N times on a transient failure. `--fit TARGET`
fits scene parameters to a target image instead of rendering: on the card
with the recording and backward kernels, or with `--cpu` by autograd
through the plain renderer.

Usage:
  python -m tracer_torch.cli --default > config.txt
  python -m tracer_torch.cli --gpu --format bin < config.txt
  python -m tracer_torch.cli --gpu --bvh --stratify < config.txt
  python -m tracer_torch.cli --gpu --ref-rng --retries 2 < config.txt
  python -m tracer_torch.cli --cpu --config config.txt --frames 1
  python -m tracer_torch.cli --gpu --fit target.bin --config config.txt \
      --fit-params materials.albedo --fit-steps 200

Two flags of the JAX CLI are accepted by the parser and refused with exit
code 2 (`not yet ported: --X`): `--fast-math` (bf16x3 matrix products, a
TPU layout the port does not take) and `--backend tpu` (no TPU here).
"""

from __future__ import annotations

import argparse
import os
import sys

# flag -> how to tell it was given, for the flags whose code is not ported
_UNPORTED = {
    "--fast-math": lambda a: a.fast_math,
    "--backend tpu": lambda a: a.backend == "tpu",
}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tracer-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--gpu", action="store_true",
                   help="render with the CUDA megakernel (fails without a CUDA device)")
    p.add_argument("--pallas", action="store_true",
                   help="same as --gpu (kept so the reference workload's command runs)")
    p.add_argument("--cpu", action="store_true", help="render with the PyTorch twin on the CPU")
    p.add_argument("--default", action="store_true", help="print the sample config and exit")
    p.add_argument("--smoke", action="store_true", help="print the fast smoke-test config and exit")
    p.add_argument("--config", type=str, default=None, help="config file (default: stdin)")
    p.add_argument("--backend", choices=["tpu", "cpu", "auto"], default="auto",
                   help="auto: the CUDA kernels (fails without a CUDA device); cpu: the twin")
    p.add_argument("--format", choices=["bin", "png", "ppm"], default="bin",
                   help="output format (bin matches the reference BinarySaver)")
    p.add_argument("--frames", type=int, default=None, help="render only the first N frames")
    p.add_argument("--rr", type=int, default=None, metavar="DEPTH",
                   help="Russian-roulette path termination from bounce DEPTH on")
    p.add_argument("--no-quirk", action="store_true",
                   help="use corrected j*width+i pixel seeding instead of the reference quirk")
    p.add_argument("--no-saver-quirk", action="store_true",
                   help="divide saved images by the true sample count instead of "
                        "the reference's sqrt_spp (camera.cu:300)")
    p.add_argument("--fit", metavar="TARGET", default=None,
                   help="inverse rendering: fit scene parameters to a target image "
                        "(png/bin written by this tool) instead of rendering")
    p.add_argument("--fit-params", default="materials.albedo",
                   help="comma-separated dotted Scene paths to optimize")
    p.add_argument("--fit-steps", type=int, default=100)
    p.add_argument("--fit-lr", type=float, default=1e-2)
    p.add_argument("--fit-checkpoint", default=None,
                   help="npz checkpoint path (resumes if it exists)")
    p.add_argument("--bvh", action="store_true",
                   help="use BVH traversal instead of brute force (the BVH kernel with --gpu)")
    p.add_argument("--stratify", action="store_true",
                   help="stratified sub-pixel jitter: sample s in cell (s mod k, s // k) of "
                        "the k x k grid, k = sqrt_rays_per_pixel")
    p.add_argument("--ref-rng", action="store_true",
                   help="reference-stream RNG: per-ray wang_hash streams advance exactly like "
                        "the reference binary (rejection sampling)")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="retry each frame up to N times on transient failures (a dropped "
                        "connection, a timeout); a CUDA error is never retried")
    # accepted for command compatibility with tracer.cli; refused below
    p.add_argument("--fast-math", action="store_true", help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from tracer_torch.scene import config as config_mod

    if args.default:
        sys.stdout.write(config_mod.default_config_text())
        return 0
    if args.smoke:
        sys.stdout.write(config_mod.smoke_config_text())
        return 0
    for flag, given in _UNPORTED.items():
        if given(args):
            print(f"tracer: not yet ported: {flag}", file=sys.stderr)
            return 2
    if args.cpu and (args.gpu or args.pallas):
        print("tracer: --cpu and --gpu exclude each other", file=sys.stderr)
        return 2
    if args.ref_rng and (args.rr is not None or args.fit):
        # the roulette's draw and the gradient kernels belong to the fixed stream
        print(f"tracer: --ref-rng and {'--rr' if args.rr is not None else '--fit'} exclude "
              f"each other", file=sys.stderr)
        return 2
    if args.retries < 0:
        print("tracer: --retries must be >= 0", file=sys.stderr)
        return 2

    import torch

    if args.cpu or (args.backend == "cpu" and not (args.gpu or args.pallas)):
        device, engine = torch.device("cpu"), "torch"
    elif not torch.cuda.is_available():
        flag = "--gpu" if args.gpu or args.pallas else "rendering without --cpu"
        print(f"tracer: {flag} needs a CUDA device and none is available", file=sys.stderr)
        return 1
    else:
        device, engine = torch.device("cuda"), "cuda"

    try:
        if args.config:
            with open(args.config) as f:
                params = config_mod.read_scene_params(f)
        else:
            params = config_mod.read_scene_params(sys.stdin)
    except (ValueError, OSError) as e:
        print(f"tracer: bad config: {e}", file=sys.stderr)
        return 2
    if args.frames is not None:
        params.num_frames = min(params.num_frames, args.frames)

    from tracer_torch.render import driver
    from tracer_torch.scene import builders

    scene = builders.create_scene(params, with_bvh=args.bvh, device=device)
    if args.fit:
        return _run_fit(args, scene, params, engine)
    out_dir = os.path.dirname(params.output_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    driver.render_animation(
        scene,
        params,
        saver=args.format,
        reference_quirk=not args.no_quirk,
        engine=engine,
        saver_spp_quirk=not args.no_saver_quirk,
        rr_start=args.rr,
        stratify=args.stratify,
        intersector="bvh" if args.bvh else "brute",
        rng_mode="reference" if args.ref_rng else "fixed",
        retries=args.retries,
    )
    return 0


def _run_fit(args, scene, params, engine: str) -> int:
    """Fit the named scene parameters to a target image (tracer/cli.py:_run_fit)."""
    import numpy as np
    import torch

    from tracer_torch.io import image as image_io
    from tracer_torch.opt import fit as fit_mod
    from tracer_torch.render import camera as camera_mod

    # dispatch on content, not extension: the reference-parity saver writes
    # int32-header binary frames to .png-named paths (camera.cu:298-300)
    with open(args.fit, "rb") as f:
        magic = f.read(2)
    if magic in (b"\x89P", b"P3", b"P6"):
        from PIL import Image

        q = np.asarray(Image.open(args.fit).convert("RGB"), np.float32)
    else:
        q = image_io.read_binary(args.fit).astype(np.float32)
    sqrt_spp = params.render.sqrt_rays_per_pixel
    spp = sqrt_spp * sqrt_spp
    # invert the saver quantize (camera.cu:64-73): byte = int(256*sqrt(sum/div)),
    # so sum/div lies in [(b/256)^2, ((b+1)/256)^2); centre at b+0.5
    divisor = spp if args.no_saver_quirk else sqrt_spp
    target = ((q + 0.5) / 256.0) ** 2 * (divisor / spp)
    h, w = target.shape[:2]
    if (w, h) != (params.width, params.height):
        print(f"tracer: target is {w}x{h}, config says "
              f"{params.width}x{params.height}", file=sys.stderr)
        return 2

    dev = scene.device
    lookfrom, lookat = camera_mod.camera_path_position(params.camera_path, 0, params.num_frames,
                                                       device=dev)
    cam = camera_mod.build_camera_data(lookfrom, lookat, w, h, vfov=params.fov_degrees,
                                       device=dev)
    paths = tuple(p for p in args.fit_params.split(",") if p)
    # "camera.*" params: the config's frame-0 camera seeds the spec
    cam_spec = None
    if any(p.startswith("camera.") for p in paths):
        cam_spec = dict(origin=lookfrom, look_at=lookat, vfov=float(params.fov_degrees))
    if args.bvh and engine == "cuda":
        print("tracer: --fit differentiates with the brute-force kernels on the card; "
              "--bvh --fit needs --cpu", file=sys.stderr)
        return 2
    out = fit_mod.fit(scene, cam, target, w, h, spp=spp, max_depth=params.render.max_depth,
                      param_paths=paths, steps=args.fit_steps, learning_rate=args.fit_lr,
                      checkpoint_path=args.fit_checkpoint, cam_spec=cam_spec, engine=engine,
                      stratify=args.stratify, intersector="bvh" if args.bvh else "brute")
    fitted, losses = out[:2]
    for path in paths:
        if path.startswith("camera."):
            val = out[2][path[len("camera."):]]
        else:
            val = fit_mod.get_path(fitted, path)
        if torch.is_tensor(val):
            val = val.detach().cpu().numpy()
        print(f"{path} = {np.asarray(val).tolist()}")
    print(f"final loss: {losses[-1] if losses else float('nan'):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
