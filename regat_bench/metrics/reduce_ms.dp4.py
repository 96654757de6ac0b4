"""reduce_ms.dp4: device-busy ms per train step in the `reduce` phase, from
the program's `reduce` mark to its `optimizer` mark: the write of the
rank's gradient sums into the flat buffer and their all-reduce over the
ranks (NCCL), over the traced epoch's train steps (regat_bench/phases.py).
None where the steps mark no `reduce` (no process group)."""

from regat_bench import phases


def read(rec):
    if rec.trace is None or not any(name == "reduce" for name, _, _ in phases.marks(rec.trace)):
        return None
    return phases.phase_ms(rec, "reduce")
