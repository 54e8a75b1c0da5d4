"""Share of the traced window spent in device kernels launched inside
`tracer.band.all_reduce` (NCCL's, which sum the row bands into the frame),
averaged over the ranks. It holds a rank's wait there for the slowest band,
which `device_idle_pct.fwd` counts as busy. Moves `mrays_per_s`; nothing to
read where the program recorded no band span."""


def read(readings):
    ranks = readings.get("ranks") or ()
    if not ranks or not all("tracer.band.all_reduce" in (r.get("spans") or {}) for r in ranks):
        return None
    return sum(100.0 * r["span_kernels"].get("tracer.band.all_reduce", 0.0) / r["window_s"]
               for r in ranks) / len(ranks)
