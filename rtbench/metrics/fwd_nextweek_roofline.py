"""The forward kernels' share of their roofline in a cell of book 2's scene
(moving spheres, media, the Perlin marble): fwd_roofline's work
(rtbench/metrics/fwd_roofline.py, its operations and bytes as they are)
plus the least operations of a time draw for every camera sample, of a
medium test for every medium boundary tested, of a turbulence for every
marble evaluation and of an isotropic scatter for every query a medium
won, and the noise's tables read once a frame, over the same counted
launches' `trace_kernel` time. Nothing to read where the counted kernels
count no medium tests (a program before those counters).

  OPS_TIME     a time draw: the uint32 to float conversion and its scale
  OPS_MEDIUM   a medium boundary: oc (3), oc.d (5), oc.oc - r^2 (7), the
               discriminant (3) and its test (1), the free flight's draw (2)
  OPS_TURB     perlin::turb's 7 octaves, each 3 floors and 3 differences,
               the Hermite weights (12), 8 corners of 3 offsets, a dot (5),
               3 weight products and the sum (12 each), the octave's weight
               and sum (2) and the point's doubling (3): 7 x 119; then the
               marble's scale z + 10 turb, its sine, 1 + and 0.5 x (6)
  OPS_ISO      an isotropic scatter: the point o + t d (6), the ball (a
               unit vector 14, the cube root and its 3 products) and the
               throughput (3)
  NOISE_BYTES  the noise's 256 gradient vectors and three permutations of
               256, float32
"""

from rtbench.harness import peaks, spec

ROOFLINE = spec.metric_reader("fwd_roofline")
OPS_TIME = 2
OPS_MEDIUM = 21
OPS_TURB = 7 * 119 + 6
OPS_ISO = 27
NOISE_BYTES = 4 * (256 * 3 + 3 * 256)


def ops(work: dict) -> int:
    return (ROOFLINE.ops(work) + OPS_TIME * work["samples"] + OPS_MEDIUM * work["medium_tests"]
            + OPS_TURB * work["noise_evals"] + OPS_ISO * work["medium_scatters"])


def nbytes(facts: dict) -> int:
    return ROOFLINE.nbytes(facts) + facts["frames"] * NOISE_BYTES


def read(readings):
    ranks = [r for r in readings.get("ranks") or () if r.get("work")]
    spent = sum(r["counted_kernel_s"] for r in ranks)
    if not ranks or spent <= 0 or any("medium_tests" not in r["work"] for r in ranks):
        return None
    least = sum(peaks.roofline_s(ops(r["work"]), nbytes(r["facts"]))[0] for r in ranks)
    return 100.0 * least / spent
