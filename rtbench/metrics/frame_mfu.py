"""The frames' share of the cards' FP32 peak: fwd_roofline's operations
(work no traversal avoids) of the window's first frames over the time
from the window's start to the end of those frames' last forward launch,
times the peak, summed over the cards. It bounds the forward kernels'
roofline from the frame's side, so a change that moves work out of the
kernels the roofline reads still shows here."""

from rtbench.harness import peaks, spec

ROOFLINE = spec.metric_reader("fwd_roofline")


def read(readings):
    ranks = readings.get("ranks") or ()
    if not ranks or any(not r.get("work") for r in ranks if r["facts"]["rows"]):
        return None
    done = sum(ROOFLINE.ops(r["work"]) for r in ranks if r.get("work"))
    cards = sum(r["counted_span_s"] for r in ranks) * peaks.PEAK_FP32_FLOPS
    return 100.0 * done / cards if done and cards else None
