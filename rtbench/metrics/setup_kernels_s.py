"""Rank 0's set-up seconds inside the program's kernel spans: the kernels'
build and load (`tracer.kernels.*`) and the host side of the launches
before the window (`tracer.launch`: the warm-up launch, with the kernels'
lazy load on the card). Moves `setup_s`; nothing to read where the program
recorded no such span."""

from rtbench.harness import spans


def read(readings):
    ranks = readings.get("ranks")
    setup = ranks[0].get("setup_spans") if ranks else None
    got = [(a, b) for name, a, b in setup or ()
           if (name.startswith("tracer.kernels.") or name == "tracer.launch")]
    return spans.union_s(got) if got else None
