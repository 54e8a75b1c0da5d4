"""Rank 0's set-up seconds inside the program's scene and BVH spans
(`tracer.scene.*`: host buffers, tables and the texture to the device;
`tracer.bvh.*`: the BVH's build and upload). Moves `setup_s`; nothing to
read where the program recorded no such span."""

from rtbench.harness import spans


def read(readings):
    ranks = readings.get("ranks")
    setup = ranks[0].get("setup_spans") if ranks else None
    got = [(a, b) for name, a, b in setup or ()
           if name.startswith(("tracer.scene.", "tracer.bvh."))]
    return spans.union_s(got) if got else None
