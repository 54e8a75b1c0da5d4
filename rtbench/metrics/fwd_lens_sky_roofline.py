"""The forward kernels' share of their roofline in a cell with a thin lens and
a sky: fwd_roofline's work (rtbench/metrics/fwd_roofline.py, its
operations and bytes as they are) plus the least operations of a lens
sample for every camera sample and of a sky evaluation for every escape
(a query that hit nothing: queries - hits), over the same counted
launches' `trace_kernel` time. Nothing to read where the counted kernels
count no samples (a program before that counter).

  OPS_LENS  a point on the lens: sqrt, the angle, cos and sin, r cos and
            r sin, the offset over the lens basis (6 multiplies, 3 adds) and
            the origin's 3 adds
  OPS_SKY   the sky: |d|^2 (5), its root and reciprocal (2), unit(d).z and
            0.5 (. + 1) (3), the lerp (1 - t once, then two multiplies and
            an add a channel: 10) and beta times it (3)
"""

from rtbench.harness import peaks, spec

ROOFLINE = spec.metric_reader("fwd_roofline")
OPS_LENS = 18
OPS_SKY = 23


def ops(work: dict) -> int:
    escapes = work["queries"] - work["hits"]
    return ROOFLINE.ops(work) + OPS_LENS * work["samples"] + OPS_SKY * escapes


def read(readings):
    ranks = [r for r in readings.get("ranks") or () if r.get("work")]
    spent = sum(r["counted_kernel_s"] for r in ranks)
    if not ranks or spent <= 0 or any("samples" not in r["work"] for r in ranks):
        return None
    least = sum(peaks.roofline_s(ops(r["work"]), ROOFLINE.nbytes(r["facts"]))[0] for r in ranks)
    return 100.0 * least / spent
