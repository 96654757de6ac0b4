"""idle_share.serve: 1 - (union of the device operations' intervals) / (the
traced stretch of the serve window), in percent, from the profiler."""


def read(rec):
    if rec.trace is None or "traced_window_ns" not in rec.counters:
        return None
    lo, hi = rec.counters["traced_window_ns"]
    return 100.0 * (1.0 - rec.trace.busy_ns(lo, hi) / (hi - lo))
