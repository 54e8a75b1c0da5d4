"""Config text-format loader / default-config emitter.

Same whitespace-delimited stream format as reference `read_scene_params`
(src/main.cu:499-550), so the reference's `config.txt` works unchanged:
num_frames, output_path, width height fov, 10 eye-path floats, 10
look-at-path floats, exactly 3 bodies (main.cu:517), 4 floor corners +
texture + tint + reflection, num_lights clamped to <= 4 (main.cu:536-540),
max_depth sqrt_spp.
"""

from __future__ import annotations

import io
from typing import Iterator, TextIO

from tracer_torch.scene.params import (
    BodyParams,
    CameraPathParams,
    FloorParams,
    LightSourceParams,
    RenderParams,
    SceneParams,
)

NUM_BODIES = 3  # hardcoded in the reference parser (main.cu:517)
MAX_LIGHTS = 4  # clamp (main.cu:536-540)


def _tokens(stream: TextIO) -> Iterator[str]:
    for line in stream:
        yield from line.split()


def read_scene_params(stream) -> SceneParams:
    """Parse the reference config stream format (main.cu:499-550)."""
    if isinstance(stream, str):
        stream = io.StringIO(stream)
    tok = _tokens(stream)

    def nxt() -> str:
        try:
            return next(tok)
        except StopIteration:
            raise ValueError(
                "config stream ended early — expected the reference format: "
                "num_frames, output_path, width height fov, 20 camera-path "
                "floats, 3 bodies, floor, lights, max_depth sqrt_spp "
                "(see `tracer --default`)"
            ) from None

    def f() -> float:
        return float(nxt())

    def i() -> int:
        return int(nxt())

    def s() -> str:
        return nxt()

    def v3():
        return (f(), f(), f())

    p = SceneParams()
    p.num_frames = i()
    p.output_path = s()
    p.width, p.height, p.fov_degrees = i(), i(), f()

    cp = CameraPathParams()
    cp.rc0, cp.zc0, cp.phic0 = f(), f(), f()
    cp.arc, cp.azc = f(), f()
    cp.wrc, cp.wzc, cp.wc = f(), f(), f()
    cp.prc, cp.pzc = f(), f()
    cp.rn0, cp.zn0, cp.phin0 = f(), f(), f()
    cp.arn, cp.azn = f(), f()
    cp.wrn, cp.wzn, cp.wn = f(), f(), f()
    cp.prn, cp.pzn = f(), f()
    p.camera_path = cp

    p.bodies = []
    for _ in range(NUM_BODIES):
        b = BodyParams()
        b.center = v3()
        b.col = v3()
        b.radius = f()
        b.reflection_coeff, b.transparency_coeff = f(), f()
        b.lights_on_edge = i()
        p.bodies.append(b)

    fl = FloorParams()
    fl.corners = [v3() for _ in range(4)]
    fl.texture_path = s()
    fl.tint = v3()
    fl.reflection_coeff = f()
    p.floor = fl

    num_lights = min(i(), MAX_LIGHTS)
    p.lights = []
    for _ in range(num_lights):
        l = LightSourceParams()
        l.position = v3()
        l.col = v3()
        p.lights.append(l)

    p.render = RenderParams(max_depth=i(), sqrt_rays_per_pixel=i())
    return p


def default_config_text() -> str:
    """The canonical sample config (reference print_default_config,
    main.cu:552-570) with a relative output path."""
    return "\n".join(
        [
            "100",
            "images/render_%d.png",
            "1080 720 50",
            "15.0 4.5 3.14159    0.0 4.5    0.0 1.0 1.0    0.0 -1.57",
            "0.0 4.5 0.0    0.0 4.5    0.0 1.0 0.0    0.0 -1.57",
            "0.0 0.0 3.0     0.3 0.0 0.0     3.0     1.5     0.1     3",
            "4 0.0 6.0     0.0 0.3 0.0     3.0     1.2     0.1     2",
            "8 0.0 9.0     0.0 0.0 0.3     3.0     1     0.1     1",
            "-15.0 -15.0 -1.0      -15.0 15.0 -1.0       15.0 15.0 -1.0        15.0 -15.0 -1.0 floor.jpg",
            "1.0 1.0 1.0",
            "0.3",
            "4",
            "-15.0 -15.0 1  10.0 10.0 10.0",
            "-15.0 15.0 1   10.0 10.0 10.0",
            "15.0 15.0 1    10.0 10.0 10.0",
            "15.0 -15.0 1   10.0 10.0 10.0",
            "50 50",
        ]
    ) + "\n"


def smoke_config_text() -> str:
    """The fast smoke config (reference create_test_config.py:6-79):
    1 frame, 200x100, fov 90, static camera, depth 5, sqrt_spp 2."""
    return "\n".join(
        [
            "1",
            "test_output_%d.png",
            "200 100 90",
            "15.0 4.5 3.14159",
            "0.0 0.0",
            "0.0 0.0 0.0",
            "0.0 0.0",
            "0.0 4.5 0.0",
            "0.0 0.0",
            "0.0 0.0 0.0",
            "0.0 0.0",
            "0.0 0.0 3.0", "0.3 0.0 0.0", "3.0", "1.5 0.1", "3",
            "4.0 0.0 6.0", "0.0 0.3 0.0", "3.0", "1.2 0.1", "2",
            "8.0 0.0 9.0", "0.0 0.0 0.3", "3.0", "1.0 0.1", "1",
            "-15.0 -15.0 -1.0",
            "-15.0 15.0 -1.0",
            "15.0 15.0 -1.0",
            "15.0 -15.0 -1.0",
            "floor.jpg",
            "1.0 1.0 1.0",
            "0.3",
            "4",
            "-15.0 -15.0 10.0", "10.0 10.0 10.0",
            "-15.0 15.0 10.0", "10.0 10.0 10.0",
            "15.0 15.0 10.0", "10.0 10.0 10.0",
            "15.0 -15.0 10.0", "10.0 10.0 10.0",
            "5 2",
        ]
    ) + "\n"
