"""The share of the forward kernels' scattering warp passes whose scattering
lanes take more than one material branch (the material code), from the
counted kernels over every launch of the window's first frames: such a pass
runs each branch its lanes take, one after another. Moves `mrays_per_s`;
nothing to read where the counted kernels count no scattering passes (a
program before those counters)."""


def read(readings):
    ranks = [r for r in readings.get("ranks") or () if r.get("work")]
    passes = sum(r["work"].get("scatter_passes", 0) for r in ranks)
    if not passes:
        return None
    return 100.0 * sum(r["work"]["mixed_passes"] for r in ranks) / passes
