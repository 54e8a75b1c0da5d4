"""The share of the forward kernels' hits and medium scatters that a
medium's free flight won (book 2's constant media), from the counted
kernels over every launch of the window's first frames: each such query
scatters isotropically in the fog or the smoke, where the rest shade a
surface. Moves `mrays_per_s`; nothing to read where the counted kernels
count no medium scatters (a program before that counter)."""


def read(readings):
    ranks = [r for r in readings.get("ranks") or () if r.get("work")]
    if not ranks or any("medium_scatters" not in r["work"] for r in ranks):
        return None
    won = sum(r["work"]["medium_scatters"] for r in ranks)
    both = won + sum(r["work"]["hits"] for r in ranks)
    return 100.0 * won / both if both else None
