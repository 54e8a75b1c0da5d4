"""The forward kernels' share of their roofline: the least time the card
could take for the work every nearest-hit query needs, whatever
intersector (K1, K1-cl, K1-bvh or a later one) does it, over the time the
forward kernels (`trace_kernel` in the trace) took for it: the launches
of the window's first frames (the entry's COUNT_FRAMES), which the counted
kernels launch again after the window.

Work no traversal avoids, from the counted kernels' queries and hits:
  operations  OPS_PLANE a query (the cheapest primitive test: n.d, n.o and
              the root) + OPS_SHADE a hit (normal, scatter directions,
              throughput)
  bytes       a frame reads the scene tables, the BVH records and the
              texture once, and writes its frame once
Bound by operations on every cell so far. Peaks: harness/peaks.py.
"""

from rtbench.harness import peaks

OPS_PLANE = 12
OPS_SHADE = 60
SPHERE_FLOATS, PLANE_FLOATS, JOIN_FLOATS, CAMERA_FLOATS = 4, 20, 13, 15
BVH_RECORD_BYTES = 64


def ops(work: dict) -> int:
    return work["queries"] * OPS_PLANE + work["hits"] * OPS_SHADE


def nbytes(facts: dict) -> int:
    s, p = facts["num_spheres"], facts["num_planes"]
    tables = 4 * (s * SPHERE_FLOATS + p * PLANE_FLOATS + (s + p) * JOIN_FLOATS + CAMERA_FLOATS)
    per_frame = (tables + 12 * facts["texels"] + BVH_RECORD_BYTES * facts["bvh_records"]
                 + 12 * facts["width"] * facts["rows"])
    return facts["frames"] * per_frame


def least_s(rank: dict) -> float:
    return peaks.roofline_s(ops(rank["work"]), nbytes(rank["facts"]))[0]


def read(readings):
    ranks = [r for r in readings.get("ranks") or () if r.get("work")]
    spent = sum(r["counted_kernel_s"] for r in ranks)
    if not ranks or spent <= 0:
        return None
    return 100.0 * sum(least_s(r) for r in ranks) / spent
