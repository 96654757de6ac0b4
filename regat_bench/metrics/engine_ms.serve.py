"""engine_ms.serve: the mean host milliseconds of InferenceEngine.step over
the window's engine calls (each ends on the answers on the host)."""


def read(rec):
    return rec.counters.get("engine_ms")
