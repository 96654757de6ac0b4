"""backward_ms.train: device-busy ms per train step in the `backward` phase,
between the program's `backward` mark and the next boundary mark, over the
traced epoch's train steps (regat_bench/phases.py)."""

from regat_bench import phases


def read(rec):
    return phases.phase_ms(rec, "backward")
