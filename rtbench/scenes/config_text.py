"""Scene kind `config_text`: a deployment written in the reference's config
format, its floor texture drawn from the seed.

`inputs` makes what both sides get (the text and the texture), `program`
builds the program's scene and parameters from them through its own
parser and builder, `reference` works the scene out again with the
frozen copy in rtbench/reference (rendered by `plain.render_samples`),
`tiny` cuts the deployment to a CPU-sized run for the tests.
"""

from __future__ import annotations

import torch

from rtbench.reference import config_text as ref_config
from rtbench.reference import plain


def inputs(cfg: dict, seed: int, device) -> dict:
    """The config text, and the texture as uniform texels in [low, high),
    drawn on `device` from `seed`."""
    tx = cfg["texture"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    tex = torch.rand((tx["height"], tx["width"], 3), generator=g, device=device)
    tex = tex * (tx["high"] - tx["low"]) + tx["low"]
    return {"text": "\n".join(cfg["text"]) + "\n", "texture": tex.cpu().numpy()}


def program(inp: dict, cfg: dict, device, with_bvh: bool):
    """(scene, SceneParams) through tracer_torch's parser and create_scene."""
    from tracer_torch.scene import builders, config

    params = config.read_scene_params(inp["text"])
    scene = builders.create_scene(params, with_bvh=with_bvh,
                                  texture_loader=lambda _path: inp["texture"], device=device)
    return scene, params


def reference(inp: dict, cfg: dict, device, dtype):
    """(RefScene, camera of frame n, settings) from the frozen parser and
    builder."""
    p = ref_config.parse(inp["text"])
    scene = plain.scene_from_arrays(ref_config.arrays(p, inp["texture"]), device, dtype)
    settings = {k: p[k] for k in ("width", "height", "sqrt_spp", "max_depth", "num_frames")}
    return scene, (lambda n: ref_config.camera(p, n, device)), settings


def tiny(cfg: dict) -> dict:
    """24x16 frames of 16 spp at depth 5 over a 20x13 texture."""
    text = list(cfg["text"])
    text[2], text[-1] = "24 16 50", "5 4"
    return dict(cfg, text=text, texture=dict(cfg["texture"], height=13, width=20))
