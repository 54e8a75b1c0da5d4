"""Share of the traced window in which no kernel, copy or set ran on the
device, averaged over the ranks (torch.profiler's device activity). Moves
`mrays_per_s`: the host's part of a frame (camera, launches, the frame's
copy back, the writer) and waits between launches show here."""


def read(readings):
    ranks = readings.get("ranks")
    if not ranks or any(r["device_events"] == 0 for r in ranks):
        return None
    return sum(100.0 * (1.0 - r["busy_s"] / r["window_s"]) for r in ranks) / len(ranks)
