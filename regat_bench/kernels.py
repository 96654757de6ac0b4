"""The program's hand-written kernels as the profiler names them, and their
roofline share over a traced pass (the per-layer readers' shared part)."""

from __future__ import annotations

from typing import Callable, Optional

from regat_bench import flops


def is_b1_train(name: str) -> bool:
    """B1's train variant: implicit_attention_kernel<true> (mangled ILb1E)."""
    return "implicit_attention_kernel" in name and ("<true>" in name or "ILb1E" in name)


def is_b1_eval(name: str) -> bool:
    return "implicit_attention_kernel" in name and ("<false>" in name or "ILb0E" in name)


def is_b2(name: str) -> bool:
    return "graph_attention_kernel" in name


def launched(counts) -> int:
    """B1's and B2's launches, train and eval, in the program's replay-aware
    counters (`train/graphs.py::launch_counts`)."""
    (b1, _), (b2, _) = counts
    return b1["train_launches"] + b1["launches"] + b2["launches"]


def recorded(trace, spans) -> int:
    """B1's and B2's calls that `trace` recorded inside the harness spans
    named `spans`."""
    return sum(1 for name in spans for s, e in trace.windows(name) for op in trace.ops(s, e)
               if is_b1_train(op[0]) or is_b1_eval(op[0]) or is_b2(op[0]))


def roofline(rec, span: str, match: Callable[[str], bool], kernel: str,
             train: bool) -> Optional[float]:
    """The kernel's least time per call (its bytes and operations at the
    pass's batch per chip) over its mean device time per call inside the
    harness spans `span`; None when the trace holds no such call."""
    if rec.trace is None:
        return None
    calls = [op for s, e in rec.trace.windows(span) for op in rec.trace.ops(s, e)
             if match(op[0])]
    if not calls:
        return None
    per_call = sum(e - s for _, s, e in calls) / len(calls) / 1e9
    b = rec.counters["train_batch" if train else "eval_batch"]
    cost = flops.b1_cost(rec.cfg, b, train) if kernel == "b1" else flops.b2_cost(rec.cfg, b)
    return flops.roofline_percent(*cost, per_call)
