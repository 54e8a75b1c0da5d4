"""Scene kind `rtiow_final`: the final render of Shirley's "Ray Tracing in One
Weekend" (book 1, v3.2.3, section 13.1): a ground sphere, up to 484 small
spheres on the book's grid (80% diffuse, 15% fuzzed metal, 5% glass) and
three large ones, one material each, under a sky, through a thin lens.
The layout is drawn from the configuration's generator seed in the book's
order; the run's seed draws nothing here but the sampled pixels.

The program side needs the program's thin lens (CameraPathParams'
`aperture`, `focus_dist`), its sky (`Scene.sky`) and the book's two
materials (RTIOW_LAMBERTIAN, RTIOW_METAL): without them it raises at once.
The reference side and its estimator are rtbench/reference/rtiow_final.py,
which lists the departures from the book.
"""

from __future__ import annotations

import numpy as np

from rtbench.reference import rtiow_final as ref
from rtbench.reference.rtiow_final import render_samples  # noqa: F401  (the kind's estimator)


def inputs(cfg: dict, seed: int, device) -> dict:
    return {"layout": ref.layout(cfg["grid"], cfg["generator_seed"]), "camera": cfg["camera"],
            "sky": cfg["sky"], "width": cfg["width"], "height": cfg["height"],
            "num_frames": cfg["num_frames"]}


def program(inp: dict, cfg: dict, device, with_bvh: bool):
    """(scene, SceneParams): the spheres through tracer_torch's scene buffers
    (and its BVH builder) in the port's frame, the sky on the scene, the
    pose as a static camera path with its lens."""
    from tracer_torch.scene import builders
    from tracer_torch.scene import types as T
    from tracer_torch.scene.params import CameraPathParams, RenderParams, SceneParams

    if not (hasattr(T, "Sky") and hasattr(T, "RTIOW_METAL")
            and hasattr(CameraPathParams(), "aperture")):
        raise RuntimeError("this program has no thin lens, sky or RTIOW materials: it cannot "
                           "render the RTIOW final scene")
    lay = inp["layout"]
    buf = builders.SceneBuffers()
    for c, r, k, alb, fz in zip(ref.to_port(lay["center"]), lay["radius"], lay["kind"],
                                lay["albedo"], lay["fuzz"]):
        m = buf.add_material(int(k), fuzz=fz, ir=1.5 if k == T.DIELECTRIC else 1.0,
                             albedo=np.asarray(alb, np.float32))
        buf.add_sphere(c, r, m)
    scene = builders.buffers_to_scene(buf, device, with_bvh=with_bvh)
    scene = scene._replace(sky=T.make_sky(inp["sky"]["bottom"], inp["sky"]["top"], device))
    cam = cfg["camera"]
    p = ref.path(cam)
    params = SceneParams(num_frames=cfg["num_frames"], width=cfg["width"], height=cfg["height"],
                         fov_degrees=cam["vfov"],
                         camera_path=CameraPathParams(rc0=p["rc0"], phic0=p["phic0"],
                                                      zc0=p["zc0"], zn0=p["zn0"],
                                                      aperture=cam["aperture"],
                                                      focus_dist=cam["focus_dist"]),
                         render=RenderParams(max_depth=cfg["max_depth"],
                                             sqrt_rays_per_pixel=cfg["sqrt_spp"]))
    return scene, params


def reference(inp: dict, cfg: dict, device, dtype):
    settings = {k: cfg[k] for k in ("width", "height", "sqrt_spp", "max_depth", "num_frames")}
    return ref.scene(inp, device, dtype), (lambda n: ref.camera(inp, n, device)), settings


def tiny(cfg: dict) -> dict:
    """A 4 x 4 grid, 48x32 frames of 16 spp at depth 5."""
    return dict(cfg, grid=2, width=48, height=32, sqrt_spp=4, max_depth=5)
