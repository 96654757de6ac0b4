"""b1_backward_ms.train: device-busy ms per train step inside B1's backward,
between the program's `b1_backward_begin` and `b1_backward_end` marks (both
directions), over the traced epoch's train steps (regat_bench/phases.py)."""

from regat_bench import phases


def read(rec):
    return phases.pair_ms(rec, "b1_backward")
