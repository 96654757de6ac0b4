"""allreduce_ms.dp4: device milliseconds of the NCCL kernels per optimizer
step in the traced train pass (rank 0's card), from the profiler."""


def read(rec):
    if rec.trace is None or not rec.counters.get("traced_train_steps"):
        return None
    passes = rec.trace.windows("train_pass")
    ns = sum(e - s for lo, hi in passes for name, s, e in rec.trace.ops(lo, hi)
             if "nccl" in name.lower())
    if not ns:
        return None
    return ns / 1e6 / rec.counters["traced_train_steps"]
