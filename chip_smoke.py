#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. Device: the card's name and power limit.
2. Build: compiles tracer_torch/csrc/megakernel.cu with nvcc.
3. Kernel against its plain PyTorch version, on the card, on the same
   inputs: smoke scene (quirk on and off), a partial tile, an 8x8 texture,
   the canonical scene with a synthetic 1330x2000 floor texture,
   rr_start=3, and two sample chunks against one shot. Tolerance: a pixel
   agrees when its max channel |diff| < 1e-3 (float32 reassociation and FMA
   contraction flip razor-edge hits, after which a sample takes another
   valid path); >= 99% of pixels must agree and the frame means must agree
   to a relative 1e-3.
4. Main path at real size: render_animation(engine="cuda") on the
   canonical config (199 primitives, 1080x720, depth 50, synthetic floor
   texture), cut to 2 frames and sqrt_spp 4 for the time limit; checks the
   saved frames, the launch count, and a sample of pixels against the
   plain version. Then the CLI once, as a subprocess.
5. Times: the kernel's Mrays/s at 800x600, spp 32, depth 50, textured
   (best of 3 frames after a warm-up), and the plain version's at the same
   shape with spp cut to 2.

The line before the last is a JSON object describing the kernel; the last
is `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TOL_PIXEL, TOL_FRAC, TOL_MEAN = 1e-3, 0.99, 1e-3
SKY = (0.05, 0.07, 0.1)  # lights every pixel, so the comparisons see every path


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def compare(name, got, want, errs):
    """Kernel frame against the plain frame; prints and returns the verdict."""
    import torch

    got, want = got.double(), want.double()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        print(f"  {name}: non-finite values")
        return False
    d = (got - want).abs().amax(dim=-1)
    frac = (d < TOL_PIXEL).double().mean().item()
    mean_k, mean_p = got.mean().item(), want.mean().item()
    rel = abs(mean_k - mean_p) / max(abs(mean_p), 1e-30)
    lit = (want.amax(dim=-1) > 0).double().mean().item()
    ok = frac >= TOL_FRAC and rel < TOL_MEAN and mean_p > 0
    errs.append(d.max().item())
    print(f"  {name}: agree {frac:.6f} (>= {TOL_FRAC}), max|diff| {d.max().item():.6g}, "
          f"mean kernel {mean_k:.9g} plain {mean_p:.9g} rel {rel:.3g} (< {TOL_MEAN}), "
          f"lit pixels {lit:.4f} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def full_scene(device):
    """Every material and plane type, 8x8 texture on the floor (the scene
    of tests/test_parity.py:_full_scene, built with the port)."""
    import torch

    from tracer_torch.scene import types as T

    g = np.random.default_rng(11)
    tex = g.uniform(0.2, 1.0, size=(1, 8, 8, 3)).astype(np.float32)
    return T.Scene(
        spheres=T.make_spheres([[0.0, 0.0, 1.0], [2.2, 0.0, 1.0], [-2.2, 0.0, 1.0],
                                [0.0, 2.5, 4.0]], [1.0] * 4, [0, 1, 2, 3], device),
        planes=T.make_planes([T.QUAD, T.TRIANGLE, T.ELLIPSE],
                             [[-8, -8, 0], [3, -2, 0.5], [-5, -2, 0.5]],
                             [[16, 0, 0], [2, 0, 0], [2, 0, 0]],
                             [[0, 16, 0], [0, 0, 2], [0, 0, 2]], [4, 0, 0], device),
        materials=T.make_materials(
            [T.LAMBERTIAN, T.METAL, T.DIELECTRIC, T.DIFFUSE_LIGHT, T.METAL],
            [0.0, 0.3, 0.0, 0.0, 0.1], [1.0, 1.0, 1.5, 1.0, 1.0],
            [[0, 0, 0], [0, 0, 0], [0.3, 0.5, 0.1], [0, 0, 0], [0, 0, 0]],
            [[0.7, 0.3, 0.3], [0.8, 0.8, 0.9], [1, 1, 1], [0, 0, 0], [0.9, 0.9, 0.9]],
            [[0, 0, 0], [0, 0, 0], [0, 0, 0], [6, 5, 4], [0, 0, 0]],
            [-1, -1, -1, -1, 0], device),
        textures=torch.tensor(tex, device=device),
    )


def synthetic_floor(_path):
    """Stand-in for floor.jpg at its real size, as bench.py makes it."""
    return np.random.default_rng(0).uniform(0.1, 1.0, size=(1330, 2000, 3)).astype(np.float32)


def cuda_ms(fn, reps=1):
    """Device time of `fn` in ms (CUDA events), best of `reps` runs."""
    import torch

    best = math.inf
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main() -> int:
    import torch

    # ---- 1. device ----------------------------------------------------
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this run needs a CUDA GPU")
    sys.path.insert(0, HERE)
    try:
        import tracer_torch
    except ImportError as e:
        return fail(f"tracer_torch is not importable next to this script ({e})")
    if not os.path.abspath(tracer_torch.__file__).startswith(HERE + os.sep):
        return fail(f"tracer_torch came from {tracer_torch.__file__}, not from {HERE}")
    from tracer_torch.io import image as image_io
    from tracer_torch.kernels import megakernel as mk
    from tracer_torch.render import camera as C
    from tracer_torch.render import driver, renderer
    from tracer_torch.scene import builders, config

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    b = mk.build()
    print(f"[2] built {os.path.relpath(b.path, HERE)} from tracer_torch/csrc in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {b.seconds:.2f} s)", flush=True)
    for line in b.log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"    nvcc: {line.strip()}")

    # ---- 3. kernel against the plain version --------------------------
    print(f"[3] kernel vs plain on {kind}", flush=True)
    errs, ok = [], True
    smoke_p = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    smoke = builders.create_scene(smoke_p, texture_loader=lambda _: None, device=dev)
    cam = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 64, 48, 90.0,
                              background=SKY, device=dev)

    def case(name, scene, cam, w, h, spp, depth, **kw):
        got = mk.render_frame_kernel(scene, cam, w, h, spp, depth, **kw)
        torch.cuda.synchronize()
        want = renderer.render_frame(scene, cam, w, h, spp, depth, **kw)
        return compare(name, got, want, errs)

    for quirk in (True, False):
        ok &= case(f"smoke 64x48 spp4 d8 quirk={quirk}", smoke, cam, 64, 48, 4, 8,
                   reference_quirk=quirk)
    cam_p = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 20, 5, 90.0,
                                background=SKY, device=dev)
    ok &= case("partial tile 20x5 spp2 d4", smoke, cam_p, 20, 5, 2, 4)
    cam_f = C.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], 64, 48, 55.0,
                                background=SKY, device=dev)
    ok &= case("8x8 texture, all materials, 64x48 spp4 d8", full_scene(dev), cam_f, 64, 48, 4, 8)
    canon_p = config.read_scene_params(io.StringIO(config.default_config_text()))
    canon = builders.create_scene(canon_p, texture_loader=synthetic_floor, device=dev)
    cam_c = C.camera_at(canon_p.camera_path, 0, canon_p.num_frames, 96, 64,
                        canon_p.fov_degrees, background=SKY, device=dev)
    ok &= case("canonical + 1330x2000 texture 96x64 spp4 d50", canon, cam_c, 96, 64, 4, 50)
    ok &= case("smoke rr_start=3 64x48 spp4 d8", smoke, cam, 64, 48, 4, 8, rr_start=3)
    one = mk.render_frame_kernel(smoke, cam, 64, 48, 4, 8)
    two = (mk.render_frame_kernel(smoke, cam, 64, 48, 2, 8)
           + mk.render_frame_kernel(smoke, cam, 64, 48, 2, 8, sample_start=2))
    torch.cuda.synchronize()
    ok &= compare("kernel 2+2 chunks vs one shot spp4", two, one, errs)
    ok &= compare("kernel 2+2 chunks vs plain spp4", two,
                  renderer.render_frame(smoke, cam, 64, 48, 4, 8), errs)
    if not ok:
        return fail("kernel and plain version disagree")
    max_abs_err = max(errs)

    # ---- 4. main path at real size ------------------------------------
    main_p = config.read_scene_params(io.StringIO(config.default_config_text()))
    main_p.render.sqrt_rays_per_pixel = 4
    frames = range(2)
    spp = main_p.render.sqrt_rays_per_pixel ** 2
    with tempfile.TemporaryDirectory() as tmp:
        main_p.output_path = os.path.join(tmp, "frame_%d.bin")
        scene = builders.create_scene(main_p, texture_loader=synthetic_floor, device=dev)
        print(f"[4] main path: canonical config, {scene.num_spheres} spheres + "
              f"{scene.num_planes} planes, {main_p.width}x{main_p.height}, depth "
              f"{main_p.render.max_depth}, floor texture "
              f"{tuple(scene.textures.shape[1:3])}; reduced: frames 100 -> {len(frames)}, "
              f"sqrt_spp 50 -> {main_p.render.sqrt_rays_per_pixel} (run time limit)", flush=True)
        tsv = io.StringIO()
        mk.LAUNCHES = 0
        fb = driver.render_animation(scene, main_p, saver="bin", out=tsv, frames=frames,
                                     engine="cuda")
        launches = mk.LAUNCHES
        chunks = math.ceil(spp / max(1, driver.MAX_RAYS_PER_LAUNCH // (main_p.width * main_p.height)))
        print("    TSV: " + tsv.getvalue().strip().replace("\n", " | "))
        print(f"    kernel launches {launches} (frames x chunks = {len(frames)} x {chunks})")
        if launches != len(frames) * chunks:
            return fail(f"launch count {launches} != {len(frames) * chunks}")
        if len(tsv.getvalue().strip().splitlines()) != len(frames):
            return fail("TSV has not one line per frame")
        for n in frames:
            img = image_io.read_binary(main_p.output_path % n)
            print(f"    frame {n}: {img.shape} uint8, mean {img.mean():.4f}, "
                  f"nonzero {(img > 0).mean():.4f}")
            if img.shape != (main_p.height, main_p.width, 3) or not img.any():
                return fail(f"frame {n} is empty or misshapen")
    if fb.shape != (main_p.height, main_p.width, 3) or not np.isfinite(fb).all():
        return fail("main-path framebuffer is not finite [H, W, 3]")
    # the plain version on 4096 of the last frame's pixels, same samples
    sel = torch.randperm(main_p.width * main_p.height, generator=torch.Generator().manual_seed(0))[:4096]
    i_all, j_all, seeds = renderer.pixel_grid(main_p.width, main_p.height, device=dev)
    sel = sel.to(dev)
    cam_last = C.camera_at(main_p.camera_path, frames[-1], main_p.num_frames, main_p.width,
                           main_p.height, main_p.fov_degrees, device=dev)
    plain = renderer.render_pixels(scene, cam_last, i_all[sel], j_all[sel], seeds[sel], spp,
                                   main_p.render.max_depth)
    got = torch.tensor(fb, device=dev).reshape(-1, 3)[sel]
    if not compare(f"main path frame {frames[-1]}: 4096 pixels vs plain", got[:, None],
                   plain[:, None], []):
        return fail("main-path frame disagrees with the plain version")

    cfg = config.default_config_text().replace("\n50 50\n", "\n50 2\n")
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tracer_torch.cli", "--gpu", "--frames", "1", "--format", "bin"],
            input=cfg, capture_output=True, text=True, cwd=tmp, env=env, timeout=300,
        )
        print(f"    CLI --gpu (default config, sqrt_spp 2, untextured: no floor.jpg): rc "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s, stdout "
              f"{proc.stdout.strip()!r}", flush=True)
        if proc.returncode != 0:
            return fail(f"CLI failed:\n{proc.stderr[-3000:]}")
        out_file = os.path.join(tmp, "images", "render_0.png")
        img = image_io.read_binary(out_file)
        line = proc.stdout.strip().split("\t")
        if len(line) != 3 or line[0] != "0" or int(line[2]) != 1080 * 720 * 4 or not img.any():
            return fail("CLI output is not one TSV line and a nonzero frame")

    # ---- 5. times -------------------------------------------------------
    W, H, SPP, D = 800, 600, 32, 50
    cams = [C.camera_at(canon_p.camera_path, k, canon_p.num_frames, W, H, canon_p.fov_degrees,
                        device=dev) for k in range(4)]
    rays = W * H * SPP

    def kernel_best(scene, **kw):
        mk.render_frame_kernel(scene, cams[0], W, H, SPP, D, **kw)  # warm-up
        return min(cuda_ms(lambda c=c: mk.render_frame_kernel(scene, c, W, H, SPP, D, **kw))
                   for c in cams[1:])

    print(f"[5] times on {kind} ({card}), canonical scene {W}x{H} d{D}, best of 3 frames "
          f"(camera path frames 1-3) after one warm-up, CUDA events:", flush=True)
    ms_tex = kernel_best(canon)
    print(f"    kernel textured spp{SPP}: {ms_tex:.3f} ms/frame = {rays / ms_tex / 1e3:.3f} Mrays/s")
    untex = canon._replace(textures=None)
    ms_untex = kernel_best(untex)
    print(f"    kernel untextured spp{SPP}: {ms_untex:.3f} ms/frame = "
          f"{rays / ms_untex / 1e3:.3f} Mrays/s")
    ms_rr = kernel_best(untex, rr_start=3)
    print(f"    kernel untextured rr_start=3 spp{SPP}: {ms_rr:.3f} ms/frame = "
          f"{rays / ms_rr / 1e3:.3f} Mrays/s")
    PSPP = 2
    k_ms = cuda_ms(lambda: mk.render_frame_kernel(canon, cams[1], W, H, PSPP, D), reps=3)
    p_ms = cuda_ms(lambda: renderer.render_frame(canon, cams[1], W, H, PSPP, D), reps=1)
    prays = W * H * PSPP
    print(f"    same shape at spp{PSPP} (camera frame 1): kernel {k_ms:.3f} ms = "
          f"{prays / k_ms / 1e3:.3f} Mrays/s; plain PyTorch {p_ms:.3f} ms = "
          f"{prays / p_ms / 1e3:.3f} Mrays/s (plain spp cut 32 -> {PSPP} for time)")
    print(f"    card: {card}", flush=True)

    print(json.dumps({"kernels": [{
        "name": "megakernel", "route": "cuda", "source": "tracer_torch/csrc/megakernel.cu",
        "replaces": "tracer/pallas/kernels.py:33", "launches": launches,
        "max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
