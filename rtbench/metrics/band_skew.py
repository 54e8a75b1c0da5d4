"""Row bands' imbalance: the slowest rank's forward-kernel time over the
ranks' mean, in the traced window (each rank's own profiler). Every rank
waits in a frame's all_reduce for the slowest band, so a skew of s leaves
the other cards idle for a share of about 1 - 1/s. Moves `mrays_per_s`."""


def read(readings):
    times = [r["fwd_kernel_s"] for r in readings.get("ranks") or ()]
    if len(times) < 2 or not all(t > 0 for t in times):
        return None
    return max(times) / (sum(times) / len(times))
