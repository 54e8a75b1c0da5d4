"""The sphere field's reference scene: the benchmark's arrays taken as
they are (plane normal, d and w worked out by plain.scene_from_arrays),
seen from one fixed pose."""

from __future__ import annotations

from rtbench.reference import plain


def arrays(inputs: dict) -> dict:
    return dict(inputs["arrays"], texture=None)


def camera(inputs: dict, frame: int, device):
    """The same camera for every frame: a static path."""
    c = inputs["camera"]
    return plain.camera(c["from"], c["at"], inputs["width"], inputs["height"], c["fov"], device)
