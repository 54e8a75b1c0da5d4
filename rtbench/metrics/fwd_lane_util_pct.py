"""Active lanes per warp pass of the forward kernels' bounce loop, over a
warp's 32, from the counted kernels (`megakernel.loop_work`) over every
launch of the window's first frames. Lanes a warp leaves idle are work the card
cannot do; moves `mrays_per_s`."""


def read(readings):
    ranks = [r for r in readings.get("ranks") or () if r.get("work")]
    passes = sum(r["work"]["passes"] for r in ranks)
    if not passes:
        return None
    return 100.0 * sum(r["work"]["active_lanes"] for r in ranks) / (32.0 * passes)
