"""ban_backward_ms.train: device-busy ms per train step inside BAN's
backward, between the program's `ban_backward_begin` and `ban_backward_end`
span marks inside the steps' `backward` phase, over the traced epoch's
train steps (regat_bench/spans.py)."""

from regat_bench import spans


def read(rec):
    return spans.span_ms(rec, "ban_backward", "backward")
