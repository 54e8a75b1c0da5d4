from tracer_torch.core import rng, vec
from tracer_torch.core.vec import (
    cross,
    dot,
    length,
    length_squared,
    near_zero,
    reflect,
    refract,
    unit_vector,
)

K_INFINITY = 1e32  # reference: include/interval.h:3 (kInfinity)
T_MIN = 1e-3  # reference: src/camera.cu:226 Interval(0.001f, 1e30f)
T_MAX = 1e30
