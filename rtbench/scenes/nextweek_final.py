"""Scene kind `nextweek_final`: the final scene of Shirley's "Ray Tracing: The
Next Week" (book 2, v3.2.3, section 10): 400 boxes of random heights on the
ground, a rectangular light, a moving sphere, glass, fuzzed metal, a glass
sphere of blue smoke, a fog around everything, a textured earth, a Perlin
marble and a rotated cluster of 1,000 spheres. The layout is drawn from the
configuration's generator seed in the book's order, the earth's texels from
the run's seed.

The program side needs the program's moving spheres (`Scene.motion`),
media (`Scene.media`), noise (`Scene.noise`, the NOISE texture id) and the
ISOTROPIC phase function: without them it raises at once. The reference
side and its estimator are rtbench/reference/nextweek_final.py, which lists
the departures from the book.
"""

from __future__ import annotations

import torch

from rtbench.reference import nextweek_final as ref
from rtbench.reference.nextweek_final import render_samples  # noqa: F401  (the kind's estimator)


def inputs(cfg: dict, seed: int, device) -> dict:
    """The layout, and the earth's texture as uniform texels in [low, high),
    drawn on `device` from `seed`."""
    tx = cfg["earth"]["texture"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % 2**63)
    tex = torch.rand((tx["height"], tx["width"], 3), generator=g, device=device)
    tex = tex * (tx["high"] - tx["low"]) + tx["low"]
    return {"layout": ref.layout(cfg), "texture": tex.cpu().numpy(), "camera": cfg["camera"],
            "width": cfg["width"], "height": cfg["height"], "num_frames": cfg["num_frames"]}


def program(inp: dict, cfg: dict, device, with_bvh: bool):
    """(scene, SceneParams): the boxes and spheres through tracer_torch's
    scene buffers (and its BVH builder) in the port's frame, the media and
    the noise on the scene, the pose as a static camera path."""
    from tracer_torch.scene import builders
    from tracer_torch.scene import types as T
    from tracer_torch.scene.params import CameraPathParams, RenderParams, SceneParams

    if not (hasattr(T, "ISOTROPIC") and hasattr(T, "make_media") and hasattr(T, "make_noise")
            and hasattr(builders, "add_box")):
        raise RuntimeError("this program has no moving spheres, media or noise texture: it "
                           "cannot render the final scene of Ray Tracing: The Next Week")
    lay = inp["layout"]
    buf = builders.SceneBuffers()
    mats = {}
    for key, (code, alb, fuzz, ir, emit, tex) in ref.materials(cfg).items():
        mats[key] = buf.add_material(code, fuzz=fuzz, ir=ir, albedo=alb, emit=emit,
                                     tex_id=T.NOISE if tex == ref.NOISE_TEX else tex)
    ms = cfg["moving_sphere"]
    motion = ref.to_port(ms["center1"]) - ref.to_port(ms["center0"])
    for k, (c, r, key) in enumerate(ref.spheres(cfg, lay)):
        buf.add_sphere(ref.to_port(c), r, mats[key], motion=motion if k == 0 else None)
    for lo, hi in ref.ground_boxes(cfg, lay["heights"]):
        builders.add_box(buf, lo, hi, mats["ground"])
    base, u, v = ref.light_quad(cfg)
    buf.add_plane(T.QUAD, base, u, v, mats["light"])
    scene = builders.buffers_to_scene(buf, device, textures=inp["texture"][None],
                                      with_bvh=with_bvh)
    med = [cfg["smoke"], cfg["fog"]]
    scene = scene._replace(
        media=T.make_media(ref.to_port([m["center"] for m in med]), [m["radius"] for m in med],
                           [m["density"] for m in med], [m["albedo"] for m in med], device),
        noise=T.make_noise(lay["noise_vectors"], lay["noise_perm"], cfg["marble"]["scale"],
                           device))
    cam = cfg["camera"]
    p = ref.path(cam)
    params = SceneParams(num_frames=cfg["num_frames"], width=cfg["width"], height=cfg["height"],
                         fov_degrees=cam["vfov"],
                         camera_path=CameraPathParams(**{k: p[k] for k in ref.PATH_KEYS},
                                                      aperture=cam["aperture"],
                                                      focus_dist=cam["focus_dist"]),
                         render=RenderParams(max_depth=cfg["max_depth"],
                                             sqrt_rays_per_pixel=cfg["sqrt_spp"]))
    return scene, params


def reference(inp: dict, cfg: dict, device, dtype):
    settings = {k: cfg[k] for k in ("width", "height", "sqrt_spp", "max_depth", "num_frames")}
    return ref.scene(inp, cfg, device, dtype), (lambda n: ref.camera(inp, n, device)), settings


def tiny(cfg: dict) -> dict:
    """A 2 x 2 box grid moved into the camera's view, 20 cluster spheres,
    every other object kept, 32x32 frames of 16 spp at depth 5."""
    return dict(cfg, width=32, height=32, sqrt_spp=4, max_depth=5,
                ground=dict(cfg["ground"], boxes_per_side=2, x0=100.0, z0=100.0),
                cluster=dict(cfg["cluster"], count=20))
