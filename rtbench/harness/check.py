"""What decides `correct`: the program's output against the plain reference.

For frames: pixels drawn from the seed in every frame of the window, the
reference rendering them at full spp and depth from the same inputs, and
four numbers, each with the limit the cell's check file sets:

  frames_missing  frames of the window whose file is missing or malformed (0)
  byte_gap        the writer's bytes against the reference's quantised sums:
                  mean |difference| over a frame's sampled values, worst frame
  fb_rel_err      the last frame's raw sums, as render_animation returned
                  them, at its sampled pixels: sum |difference| / sum |reference|
  fb_rel_p10      the same pixels' own relative errors, |difference| / |reference|
                  summed over the channels, their 10th percentile over the
                  pixels that are not black on both sides: an error in every
                  pixel shows here, while the pixels where a sample or two
                  took another path (K1's contracted FMAs round otherwise
                  than the plain ops; up to about half the pixels on the
                  sphere field) move fb_rel_err alone

At most MAX_FRAMES_JUDGED frames of a window are judged: the last, and
others drawn from the seed.

The reference's estimator is the scene kind's own `render_samples` where
the kind defines one (rtbench/harness/spec.py), else the plain one,
`plain.render_samples`; the judge and the control both go through it.

`control(..., dtype)` computes the same numbers for the reference itself in
another precision put in the program's place: the control.
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple

import numpy as np
import torch

from rtbench.harness import spec
from rtbench.reference import plain


class Number(NamedTuple):
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


MAX_FRAMES_JUDGED = 12


def sample_pixels(seed: int, frames, width: int, height: int, k: int):
    """[(frame, flat pixel indices)]: up to MAX_FRAMES_JUDGED of `frames` in
    order, the last among them, and k distinct pixels each, from the seed."""
    rng = np.random.default_rng([seed % 2**63, 0x5EED])
    pos = list(range(len(frames)))
    if len(pos) > MAX_FRAMES_JUDGED:
        pos = sorted(rng.choice(len(pos) - 1, MAX_FRAMES_JUDGED - 1, replace=False)) + pos[-1:]
    return [(frames[q], np.sort(rng.choice(width * height, size=min(k, width * height),
                                           replace=False))) for q in pos]


def read_frame(path: str, width: int, height: int):
    """The writer's bytes [H, W, 3], or None if missing or malformed."""
    try:
        with open(path, "rb") as f:
            w, h = struct.unpack("<ii", f.read(8))
            data = np.frombuffer(f.read(), np.uint8)
    except (OSError, struct.error):
        return None
    if (w, h) != (width, height) or data.size != w * h * 3:
        return None
    return data.reshape(h, w, 3)


def reference_sums(wl, inputs, seed, frames, device, dtype):
    """(picks, [raw sums [k, 3] of each pick], settings): the reference in
    `dtype`, with the scene kind's estimator, at the pixels the seed draws
    in each of `frames`."""
    kind = spec.scene_kind(wl.config["scene"])
    render_samples = getattr(kind, "render_samples", plain.render_samples)
    scene, camera, st = kind.reference(inputs, wl.config, device, dtype)
    picks = sample_pixels(seed, frames, st["width"], st["height"], wl.check["pixels_per_frame"])
    spp = st["sqrt_spp"] ** 2
    out = []
    for n, px in picks:
        t = torch.as_tensor(px, device=device)
        out.append(render_samples(scene, camera(n), st["width"], t % st["width"],
                                  t // st["width"], spp, st["max_depth"], quirk=True,
                                  dtype=dtype).cpu().numpy())
    return picks, out, st


def numbers(picks, got_bytes, got_last, want, divisor, limits, npx: int) -> list:
    """The three numbers from the program's bytes (one [H, W, 3] or None a
    pick), its last frame's raw sums [H, W, 3] and the reference's sums."""
    gaps, missing = [], 0
    for (_n, px), b, w in zip(picks, got_bytes, want):
        if b is None:
            missing += 1
            continue
        flat = b.reshape(-1, 3)[px].astype(np.int64)
        gaps.append(float(np.abs(flat - plain.quantize(w, divisor).astype(np.int64)).mean()))
    last = np.asarray(got_last, np.float64)
    ref = want[-1].astype(np.float64)
    rel = low = float("inf")
    if last.size == npx * 3:
        diff = np.abs(last.reshape(-1, 3)[picks[-1][1]] - ref)
        rel = float(diff.sum() / max(np.abs(ref).sum(), 1e-30))
        den, num = np.abs(ref).sum(-1), diff.sum(-1)
        lit = (den > 0) | (num > 0)
        px = np.where(den > 0, num / np.maximum(den, 1e-30), np.inf)[lit]
        low = float(np.percentile(px, 10)) if px.size else 0.0
    return [Number("frames_missing", float(missing), limits["frames_missing"]),
            Number("byte_gap", max(gaps) if gaps else float("inf"), limits["byte_gap"]),
            Number("fb_rel_err", rel, limits["fb_rel_err"]),
            Number("fb_rel_p10", low, limits["fb_rel_p10"])]


def limits(wl) -> dict:
    return {k: float(v["limit"]) for k, v in wl.check["numbers"].items()}


def judge(wl, seed: int, outcome, device) -> list:
    """The program's numbers for a run's Outcome."""
    picks, want, st = reference_sums(wl, outcome.inputs, seed, outcome.frames, device,
                                     torch.float32)
    got = [read_frame(outcome.files[n], st["width"], st["height"]) for n, _ in picks]
    return numbers(picks, got, outcome.last_fb, want, outcome.saver_divisor, limits(wl),
                   st["width"] * st["height"])


def control(wl, seed: int, outcome, device, dtype=torch.bfloat16) -> list:
    """The same numbers with the reference in `dtype` in the program's
    place, on the frames and pixels the run drew."""
    picks, want, st = reference_sums(wl, outcome.inputs, seed, outcome.frames, device,
                                     torch.float32)
    _, low, _ = reference_sums(wl, outcome.inputs, seed, outcome.frames, device, dtype)
    npx = st["height"] * st["width"]
    got = []
    for (_n, px), sums in zip(picks, low):
        frame = np.zeros((npx, 3), np.uint8)
        frame[px] = plain.quantize(sums, outcome.saver_divisor)
        got.append(frame.reshape(st["height"], st["width"], 3))
    last = np.zeros((npx, 3), np.float32)
    last[picks[-1][1]] = low[-1]
    return numbers(picks, got, last, want, outcome.saver_divisor, limits(wl), npx)


def clean(outcome) -> None:
    for path in set(outcome.files.values()):
        if os.path.exists(path):
            os.remove(path)
