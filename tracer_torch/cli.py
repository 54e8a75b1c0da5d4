"""Command-line driver of the PyTorch/CUDA port (port of tracer.cli).

Covers the reference CLI (src/main.cu:572-606): `--gpu` renders a stdin
config with the CUDA megakernel, `--cpu` with the plain PyTorch twin on
the CPU, `--default` / `--smoke` print the sample configs.

Usage:
  python -m tracer_torch.cli --default > config.txt
  python -m tracer_torch.cli --gpu --format bin < config.txt
  python -m tracer_torch.cli --cpu --config config.txt --frames 1

Flags of the JAX CLI whose code is not ported yet are accepted by the
parser and refused with exit code 2 (`not yet ported: --X`).
"""

from __future__ import annotations

import argparse
import os
import sys

# flag -> how to tell it was given, for the flags whose code is not ported
_UNPORTED = {
    "--bvh": lambda a: a.bvh,
    "--fit": lambda a: a.fit is not None,
    "--fit-params": lambda a: a.fit_params is not None,
    "--fit-steps": lambda a: a.fit_steps is not None,
    "--fit-lr": lambda a: a.fit_lr is not None,
    "--fit-checkpoint": lambda a: a.fit_checkpoint is not None,
    "--ref-rng": lambda a: a.ref_rng,
    "--stratify": lambda a: a.stratify,
    "--fast-math": lambda a: a.fast_math,
    "--retries": lambda a: a.retries is not None,
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
                   help="auto: the CUDA kernel when a CUDA device is present, else the twin")
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
    # accepted for command compatibility with tracer.cli; refused below
    p.add_argument("--bvh", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--fit", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fit-params", default=None, help=argparse.SUPPRESS)
    p.add_argument("--fit-steps", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--fit-lr", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--fit-checkpoint", default=None, help=argparse.SUPPRESS)
    p.add_argument("--ref-rng", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--stratify", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--fast-math", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--retries", type=int, default=None, help=argparse.SUPPRESS)
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

    import torch

    if args.gpu or args.pallas:
        if not torch.cuda.is_available():
            print("tracer: --gpu needs a CUDA device and none is available", file=sys.stderr)
            return 1
        device, engine = torch.device("cuda"), "cuda"
    elif args.cpu or args.backend == "cpu" or not torch.cuda.is_available():
        device, engine = torch.device("cpu"), "torch"
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

    scene = builders.create_scene(params, device=device)
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
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
