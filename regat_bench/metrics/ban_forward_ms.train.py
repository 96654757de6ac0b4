"""ban_forward_ms.train: device-busy ms per train step inside BAN's forward,
between the program's `ban_forward_begin` and `ban_forward_end` span marks
inside the steps' `forward` phase (eval steps' spans left out), over the
traced epoch's train steps (regat_bench/spans.py)."""

from regat_bench import spans


def read(rec):
    return spans.span_ms(rec, "ban_forward", "forward")
