"""Published peaks of one NVIDIA H100 (SXM data sheet, dense, at its 700 W
limit). A card set below 700 W reaches less; the run records the card's
power limit beside every roofline share."""

PEAK_FP32_FLOPS = 67e12  # FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # bytes/s of HBM3


def roofline_s(ops: float, nbytes: float):
    """(least seconds, what bounds it): the larger of the operations over the
    FP32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
