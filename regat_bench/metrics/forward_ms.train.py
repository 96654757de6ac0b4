"""forward_ms.train: device-busy ms per train step in the `forward` phase,
between the program's `forward` mark and the next boundary mark, over the
traced epoch's train steps (regat_bench/phases.py)."""

from regat_bench import phases


def read(rec):
    return phases.phase_ms(rec, "forward")
