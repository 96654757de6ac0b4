"""The program's phase marks and set-up counters as the per-layer readers
read them.

A mark is an empty kernel the program launches inside each train step
(`regat_mark_<name>`), so the profiler records it on the device's clock
beside the step's work. A step marks `gather`, then per microbatch
`forward` and `backward`, then `reduce` (under a process group only),
`optimizer` and `end`; `b1_backward_begin` / `_end` and `b2_backward_begin`
/ `_end` bracket B1's and B2's backward inside `backward`. Eval steps are
not marked, so every mark of a trace belongs to a train step, and the
readers take them all: the card's clock can place a pass's last mark a few
microseconds past the harness's host span around the pass.

A phase's time is the device-busy union (`Trace.busy_ns`) between the end
of its mark and the start of the next boundary mark, a pair's between the
end of its begin mark and the start of its end mark, summed over the trace
and divided by its steps. A trace whose marks do not parse into whole steps
(the profiler lost a record), or a program without marks, reads None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

PREFIX = "regat_mark_"
BOUNDARIES = ("gather", "forward", "backward", "reduce", "optimizer", "end")
PAIRS = ("b1_backward", "b2_backward")

Mark = Tuple[str, int, int]  # name without the prefix, start ns, end ns


def marks(trace) -> List[Mark]:
    """Every mark of the trace, in start order."""
    return sorted(((name.split("(")[0][len(PREFIX):], s, e) for name, s, e in trace.device_ops
                   if name.startswith(PREFIX)), key=lambda m: m[1])


def _whole_steps(seq: List[Mark]) -> Optional[int]:
    """The number of steps the marks make, or None unless every step is
    gather, (forward, backward)+, [reduce], optimizer, end, with the pairs
    closed inside backward."""
    steps, state, opened = 0, "end", None
    follows = {"gather": ("end",), "forward": ("gather", "backward"), "backward": ("forward",),
               "reduce": ("backward",), "optimizer": ("backward", "reduce"),
               "end": ("optimizer",)}
    for name, _, _ in seq:
        if name in BOUNDARIES:
            if state not in follows[name] or opened is not None:
                return None
            state = name
            steps += name == "end"
            continue
        pair, _, edge = name.rpartition("_")
        if pair not in PAIRS or state != "backward" or (edge == "begin") != (opened is None):
            return None
        opened = pair if edge == "begin" else None
    return steps if steps and state == "end" else None


def phase_ms(rec, phase: str) -> Optional[float]:
    """Device-busy ms per train step between `phase`'s mark and the next
    boundary mark."""
    if rec.trace is None:
        return None
    seq = marks(rec.trace)
    steps = _whole_steps(seq)
    if steps is None:
        return None
    bounds = [m for m in seq if m[0] in BOUNDARIES]
    ns = sum(rec.trace.busy_ns(end, start)
             for (name, _, end), (_, start, _) in zip(bounds, bounds[1:]) if name == phase)
    return ns / 1e6 / steps


def pair_ms(rec, pair: str) -> Optional[float]:
    """Device-busy ms per train step between `pair`_begin and `pair`_end;
    None where the trace holds no such pair."""
    if rec.trace is None:
        return None
    seq = marks(rec.trace)
    steps = _whole_steps(seq)
    if steps is None:
        return None
    ns, pairs, begin = 0.0, 0, None
    for name, s, e in seq:
        if name == pair + "_begin":
            begin = e
        elif name == pair + "_end":
            ns += rec.trace.busy_ns(begin, s)
            pairs += 1
    return ns / 1e6 / steps if pairs else None


def setup_seconds(name: str) -> Optional[float]:
    """The program's set-up total `name` in host seconds (its
    train/profiling.py::setup_seconds), None where the program keeps none."""
    from tf_vqa_regat_tpu_torch.train import profiling

    totals = getattr(profiling, "setup_seconds", None)
    return None if totals is None else totals().get(name)
