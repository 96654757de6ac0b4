"""idle_share.train: 1 - (union of the device operations' intervals) / (the
traced train pass's length), in percent, from the profiler."""


def read(rec):
    if rec.trace is None:
        return None
    passes = rec.trace.windows("train_pass")
    if not passes:
        return None
    total = sum(e - s for s, e in passes)
    busy = sum(rec.trace.busy_ns(s, e) for s, e in passes)
    return 100.0 * (1.0 - busy / total)
