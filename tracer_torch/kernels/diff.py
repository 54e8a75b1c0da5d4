"""Differentiable rendering (port of tracer/pallas/diff.py:render_frame_diff).

mode="replay-kernel" (default): a `torch.autograd.Function` whose forward
is the recording kernel (9 texture tape fields, 13 with `texture_grads`)
and whose backward is the backward kernel, then the texture-gradient
scatter when `texture_grads`. The residuals are the tapes.

mode="replay" and mode="replay-sample": the same recording forward, and
a backward that is autograd through the plain replay of the winner tape
(tracer_torch.kernels.replay.replay_cotangents), the counterparts of
tracer/'s XLA replay (tracer/pallas/replay.py:render_frame_replay), which
has no Pallas kernel. So their backward is plain PyTorch on every device,
the card's included: that is their definition, not a fallback from the
backward kernel. They differ in the texture only:

  - "replay" records the 3-field tape and replays the frozen texel: a
    textured hit's multiplier is the recorded texel as a constant, so
    geometry gradients on textured surfaces lose d(texel)/d(uv);
  - "replay-sample" records the index tape alone (`tape_fields=0`) and
    samples the texture live at the replayed (u, v), with the image
    detached: d(texel)/d(uv) flows, nothing reaches the image. Its
    gradients equal "replay-kernel"'s.

Both give the texture image a zero gradient and refuse `texture_grads`.

mode="remat": autograd straight through the plain renderer
(tracer_torch.render.renderer.render_frame), the oracle, on the scene's
device; the one mode that takes `intersector="bvh"` (through the plain
BVH traversal, as tracer's XLA renderer differentiates through
hit_scene_bvh). The recording and backward kernels are brute force only,
as tracer's Pallas gradient path is.

`stratify` (every mode) stratifies the primary rays' jitter over a
sqrt(spp) x sqrt(spp) grid; the backward regenerates the same rays.

Dispatch goes by the scene's device, as render_frame_kernel's does: CPU
tensors go to the plain versions of the kernels, CUDA tensors to the
kernels or an error.
"""

from __future__ import annotations

import warnings

import torch

from tracer_torch.kernels import bwd
from tracer_torch.kernels import megakernel
from tracer_torch.kernels import replay
from tracer_torch.render import camera as camera_mod
from tracer_torch.render import integrator, renderer

MODES = ("replay-kernel", "replay", "replay-sample", "remat")
TEXTURE_GRAD_MODES = ("replay-kernel", "remat")  # the modes that can give the image a gradient


def _leaves(scene, cam):
    """The differentiable inputs: bwd.float_leaves, then the textures."""
    tex = [] if scene.textures is None else [scene.textures]
    return bwd.float_leaves(scene, cam) + tex


def _plain_replay_cotangents(scene, cam, idx, tex, g, width, height, spp, max_depth, quirk,
                             rr_start, live, strat_k):
    """The float leaves' cotangents by autograd through the plain replay:
    fed the 3-field tape `tex`, or sampling the texture live with `live`."""
    n, rows = width * height, spp * max_depth
    table, camv = bwd.pack_tables(scene, cam)
    t2 = None if tex is None else bwd._field_major(tex, spp, max_depth, n)
    dtable, dcam, _, _ = replay.replay_cotangents(
        table.detach(), camv.detach(), idx.reshape(rows, n), g.reshape(n, 3).float(), width,
        spp, max_depth, reference_quirk=quirk, rr_start=rr_start, t2=t2,
        textures=scene.textures if live else None, strat_k=strat_k)
    return bwd.leaf_cotangents(scene, cam, dtable, dcam)


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, args, *leaves):
        (scene, cam, width, height, spp, max_depth, quirk, rr_start, mode, texture_grads,
         strat_k) = args
        n = len(leaves) - (scene.textures is not None)
        scene, cam = bwd.with_float_leaves(scene, cam, leaves[:n])
        if scene.textures is not None:
            scene = scene._replace(textures=leaves[n])
        fields = {"replay-kernel": 13 if texture_grads else 9, "replay": 3}.get(mode, 0)
        out = megakernel.render_frame_kernel_record(
            scene, cam, width, height, spp, max_depth, reference_quirk=quirk,
            rr_start=rr_start, tape_fields=fields, stratify=bool(strat_k), strat_sqrt_spp=strat_k)
        ctx.args, ctx.scene, ctx.cam = args, scene, cam
        ctx.idx = out[1]
        ctx.tex = out[2] if len(out) == 3 else None
        return out[0]

    @staticmethod
    def backward(ctx, g):
        _, _, width, height, spp, max_depth, quirk, rr_start, mode, texture_grads, strat_k = ctx.args
        dtex = None
        if mode == "replay-kernel":
            grads, dtex, _ = bwd.scene_cam_cotangents(
                ctx.scene, ctx.cam, ctx.idx, g, width, height, spp, max_depth,
                reference_quirk=quirk, rr_start=rr_start, tex_tape=ctx.tex,
                texture_grads=texture_grads, stratify=bool(strat_k), strat_sqrt_spp=strat_k)
        else:
            grads = _plain_replay_cotangents(ctx.scene, ctx.cam, ctx.idx, ctx.tex, g, width,
                                             height, spp, max_depth, quirk, rr_start,
                                             live=mode == "replay-sample", strat_k=strat_k)
        ctx.idx = ctx.tex = None
        if ctx.scene.textures is not None:
            g_tex = torch.zeros_like(ctx.scene.textures)
            if dtex is not None:
                g_tex[0] += dtex
            grads.append(g_tex)
        return (None, *grads)


def render_frame_diff(scene, cam, width: int, height: int, spp: int, max_depth: int,
                      reference_quirk: bool = True, mode: str = "replay-kernel",
                      rr_start=None, texture_grads: bool = False, stratify: bool = False,
                      intersector: str = "brute"):
    """Raw sample sums `[H, W, 3]`, differentiable in the scene's float
    leaves, its textures and the camera.

    texture_grads=True (replay-kernel; remat always has them) records the
    13-field tape so that the texture image itself gets its cotangents;
    leave it False unless the texture is being optimised. Geometry
    gradients through d(texel)/d(uv) ride the 9-field tape either way.
    Modes "replay" and "replay-sample" raise on it. `intersector="bvh"`
    is taken by mode "remat" alone."""
    if texture_grads and mode not in TEXTURE_GRAD_MODES:
        raise ValueError(f"texture_grads requires mode='replay-kernel' (or 'remat', where "
                         f"texture-image gradients are always on), not {mode!r}")
    if mode == "remat":
        return renderer.render_frame(scene, cam, width, height, spp, max_depth,
                                     reference_quirk=reference_quirk, rr_start=rr_start,
                                     stratify=stratify, intersector=intersector)
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if integrator.check_intersector(intersector) == "bvh":
        raise ValueError(f"mode {mode!r} records with the brute-force kernel: intersector "
                         f"'bvh' needs mode 'remat'")
    strat_k = camera_mod.strat_grid(stratify, spp)
    texture_grads = bool(texture_grads) and scene.textures is not None
    if scene.textures is not None and scene.textures.requires_grad and not texture_grads:
        warnings.warn("the texture requires grad but texture_grads is False: its gradient "
                      "will be zero (pass texture_grads=True)", stacklevel=2)
    args = (scene, cam, width, height, spp, max_depth, reference_quirk, rr_start, mode,
            texture_grads, strat_k)
    return _Replay.apply(args, *_leaves(scene, cam))
