"""Share of the traced window in which the device is idle while the host
is inside `tracer.frame.fetch` (the frame's copy to the host), averaged
over the ranks. Moves `mrays_per_s`; nothing to read where the program
recorded no frame span."""


def read(readings):
    ranks = readings.get("ranks") or ()
    if not ranks or not all("tracer.frame" in (r.get("spans") or {}) for r in ranks):
        return None
    return sum(100.0 * r["idle_by_span"].get("tracer.frame.fetch", 0.0) / r["window_s"]
               for r in ranks) / len(ranks)
