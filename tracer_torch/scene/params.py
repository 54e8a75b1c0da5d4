"""Scene configuration dataclasses.

Python-native form of reference include/scene_params.h:8-58. Field names
follow the reference; all values are plain Python floats/ints/strings so
configs are serializable and hashable into jit static args where needed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

Vec3 = Tuple[float, float, float]


@dataclass
class CameraPathParams:
    """Sinusoidal cylindrical paths for eye and look-at (scene_params.h:8-18)."""

    rc0: float = 0.0
    zc0: float = 0.0
    phic0: float = 0.0
    arc: float = 0.0
    azc: float = 0.0
    wrc: float = 0.0
    wzc: float = 0.0
    wc: float = 0.0
    prc: float = 0.0
    pzc: float = 0.0

    rn0: float = 0.0
    zn0: float = 0.0
    phin0: float = 0.0
    arn: float = 0.0
    azn: float = 0.0
    wrn: float = 0.0
    wzn: float = 0.0
    wn: float = 0.0
    prn: float = 0.0
    pzn: float = 0.0


@dataclass
class BodyParams:
    """scene_params.h:20-27."""

    center: Vec3 = (0.0, 0.0, 0.0)
    col: Vec3 = (0.0, 0.0, 0.0)
    radius: float = 1.0
    reflection_coeff: float = 0.0
    transparency_coeff: float = 0.0
    lights_on_edge: int = 0


@dataclass
class FloorParams:
    """scene_params.h:29-34."""

    corners: List[Vec3] = field(
        default_factory=lambda: [(0.0, 0.0, 0.0)] * 4
    )
    texture_path: str = ""
    tint: Vec3 = (1.0, 1.0, 1.0)
    reflection_coeff: float = 0.0


@dataclass
class LightSourceParams:
    """scene_params.h:36-39."""

    position: Vec3 = (0.0, 0.0, 0.0)
    col: Vec3 = (1.0, 1.0, 1.0)


@dataclass
class RenderParams:
    """scene_params.h:41-44."""

    max_depth: int = 50
    sqrt_rays_per_pixel: int = 50


@dataclass
class SceneParams:
    """Aggregate (scene_params.h:46-58)."""

    num_frames: int = 1
    output_path: str = "render_%d.png"
    width: int = 640
    height: int = 480
    fov_degrees: float = 60.0
    camera_path: CameraPathParams = field(default_factory=CameraPathParams)
    bodies: List[BodyParams] = field(default_factory=list)
    floor: FloorParams = field(default_factory=FloorParams)
    lights: List[LightSourceParams] = field(default_factory=list)
    render: RenderParams = field(default_factory=RenderParams)
