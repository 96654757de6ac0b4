"""The program's span marks as the per-layer readers of a fusion read them.

A span mark is an empty kernel like a phase mark (regat_bench/phases.py),
named `regat_span_<name>`: BAN brackets its forward (`ban_forward_begin` /
`_end`) in train and eval steps alike, and its backward (`ban_backward_begin`
/ `_end`) in train steps. Their prefix is not the phase marks', so the
phase readers pass over them. A span's time is the device-busy union
(`Trace.busy_ns`) between the end of its begin mark and the start of its
end mark. Only the pairs that lie inside a train step's phase count (a
forward span inside `forward`, a backward span inside `backward`), so the
eval steps' spans are left out; the steps are those the phase marks make.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from regat_bench import flops, phases
from regat_bench.reference import fusion

PREFIX = "regat_span_"


def _windows(seq: List[phases.Mark], phase: str) -> List[Tuple[int, int]]:
    """[end of the phase's mark, start of the next boundary mark) of every
    `phase` of the phase marks `seq`."""
    bounds = [m for m in seq if m[0] in phases.BOUNDARIES]
    return [(end, start) for (name, _, end), (_, start, _) in zip(bounds, bounds[1:])
            if name == phase]


def span_ms(rec, span: str, phase: str) -> Optional[float]:
    """Device-busy ms per train step between `span`_begin and `span`_end,
    over the pairs inside the train steps' `phase`; None unless the trace's
    phase marks make whole steps and it holds one pair per step and
    microbatch there, each begin followed by its end."""
    if rec.trace is None:
        return None
    seq = phases.marks(rec.trace)
    steps = phases._whole_steps(seq)
    if steps is None:
        return None
    own = sorted(((name.split("(")[0][len(PREFIX):], s, e) for name, s, e in rec.trace.device_ops
                  if name.startswith(PREFIX + span + "_")), key=lambda m: m[1])
    ns, pairs = 0.0, 0
    for lo, hi in _windows(seq, phase):
        inside = [m for m in own if lo <= m[1] < hi]
        edges = [name[len(span) + 1:] for name, _, _ in inside]
        if edges != ["begin", "end"] * (len(inside) // 2):
            return None
        for (_, _, begin), (_, end, _) in zip(inside[::2], inside[1::2]):
            ns += rec.trace.busy_ns(begin, end)
            pairs += 1
    microbatches = int(rec.mix.get("program", {}).get("grad_accum", 1))
    if pairs != steps * microbatches:
        return None
    return ns / 1e6 / steps


def fusion_train_flops(cfg: dict) -> float:
    """The fusion's f32 operations in one question's training step, its
    products (reference/fusion/<fusion>.py::matmuls) without the
    classifier's, counted for training as flops.train_flops counts them."""
    return sum(f * (3.0 if needs_input else 2.0)
               for what, f, needs_input in fusion.load(cfg["fusion"]).matmuls(cfg)
               if not what.startswith("classifier"))


def ban_roofline(rec) -> Optional[float]:
    """The fusion's least time a train step (its training operations at the
    step's rows over the f32 peak) over the busy time of its forward and
    backward spans a step, in percent."""
    fwd = span_ms(rec, "ban_forward", "forward")
    bwd = span_ms(rec, "ban_backward", "backward")
    if fwd is None or bwd is None:
        return None
    rows = rec.counters["train_batch"]
    return flops.roofline_percent(0.0, fusion_train_flops(rec.cfg) * rows, (fwd + bwd) / 1e3)
