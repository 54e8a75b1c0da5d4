"""Differentiable rendering (port of tracer/pallas/diff.py:render_frame_diff).

mode="replay-kernel" (default): a `torch.autograd.Function` whose forward
is the recording kernel (9 texture tape fields, 13 with `texture_grads`)
and whose backward is the backward kernel, then the texture-gradient
scatter when `texture_grads`. The residuals are the tapes.

mode="remat": autograd straight through the plain renderer
(tracer_torch.render.renderer.render_frame), the oracle, on the scene's
device.

Dispatch goes by the scene's device, as render_frame_kernel's does: CPU
tensors go to the plain versions of the kernels, CUDA tensors to the
kernels or an error.
"""

from __future__ import annotations

import warnings

import torch

from tracer_torch.kernels import bwd
from tracer_torch.kernels import megakernel
from tracer_torch.render import renderer

MODES = ("replay-kernel", "remat")


def _leaves(scene, cam):
    """The differentiable inputs: bwd.float_leaves, then the textures."""
    tex = [] if scene.textures is None else [scene.textures]
    return bwd.float_leaves(scene, cam) + tex


class _ReplayKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, args, *leaves):
        scene, cam, width, height, spp, max_depth, quirk, rr_start, texture_grads = args
        n = len(leaves) - (scene.textures is not None)
        scene, cam = bwd.with_float_leaves(scene, cam, leaves[:n])
        if scene.textures is not None:
            scene = scene._replace(textures=leaves[n])
        out = megakernel.render_frame_kernel_record(
            scene, cam, width, height, spp, max_depth, reference_quirk=quirk,
            rr_start=rr_start, tape_fields=13 if texture_grads else 9)
        ctx.args, ctx.scene, ctx.cam = args, scene, cam
        ctx.idx = out[1]
        ctx.tex = out[2] if len(out) == 3 else None
        return out[0]

    @staticmethod
    def backward(ctx, g):
        _, _, width, height, spp, max_depth, quirk, rr_start, texture_grads = ctx.args
        grads, dtex, _ = bwd.scene_cam_cotangents(
            ctx.scene, ctx.cam, ctx.idx, g, width, height, spp, max_depth,
            reference_quirk=quirk, rr_start=rr_start, tex_tape=ctx.tex,
            texture_grads=texture_grads)
        ctx.idx = ctx.tex = None
        if ctx.scene.textures is not None:
            g_tex = torch.zeros_like(ctx.scene.textures)
            if dtex is not None:
                g_tex[0] += dtex
            grads.append(g_tex)
        return (None, *grads)


def render_frame_diff(scene, cam, width: int, height: int, spp: int, max_depth: int,
                      reference_quirk: bool = True, mode: str = "replay-kernel",
                      rr_start=None, texture_grads: bool = False):
    """Raw sample sums `[H, W, 3]`, differentiable in the scene's float
    leaves, its textures and the camera.

    texture_grads=True (replay-kernel; remat always has them) records the
    13-field tape so that the texture image itself gets its cotangents;
    leave it False unless the texture is being optimised. Geometry
    gradients through d(texel)/d(uv) ride the 9-field tape either way."""
    if texture_grads and mode not in MODES:
        raise ValueError(f"texture_grads requires mode='replay-kernel' (or 'remat', where "
                         f"texture-image gradients are always on), not {mode!r}")
    if mode == "remat":
        return renderer.render_frame(scene, cam, width, height, spp, max_depth,
                                     reference_quirk=reference_quirk, rr_start=rr_start)
    if mode != "replay-kernel":
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    texture_grads = bool(texture_grads) and scene.textures is not None
    if scene.textures is not None and scene.textures.requires_grad and not texture_grads:
        warnings.warn("the texture requires grad but texture_grads is False: its gradient "
                      "will be zero (pass texture_grads=True)", stacklevel=2)
    args = (scene, cam, width, height, spp, max_depth, reference_quirk, rr_start, texture_grads)
    return _ReplayKernel.apply(args, *_leaves(scene, cam))
