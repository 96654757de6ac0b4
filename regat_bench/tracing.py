"""The traced stretch of a run (`--trace 1`): torch.profiler over CPU and
CUDA activity, read in memory once it stops (no trace file is written), and
the record a per-layer metric's reader gets.

Spans are the harness's own `record_function` ranges around its calls into
the program (`span`); device operations are every kernel, copy and memset
the profiler saw on the card. Busy time is the union of the device
operations' intervals, so operations that overlap count once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from regat_bench import stats

Op = Tuple[str, int, int]  # name, start ns, end ns
# idle gaps shorter than this (launch to launch) are summed, not labelled
SHORT_GAP_NS = 5_000
SHORT_LABEL = "gaps under 5 us"


SPANS = set()  # the harness's span names (the profiler mirrors them on the card)


def span(name: str):
    """A harness span around a call into the program (a no-op cost when no
    profiler runs)."""
    SPANS.add(name)
    return torch.profiler.record_function(name)


class Trace:
    """One profiled stretch: `device_ops`, harness `spans` and the host's
    other events (`host`), in the profiler's nanoseconds."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.device_ops: List[Op] = []
        self.spans: List[Op] = []
        self.host: List[Op] = []
        self._prof = None

    def warm(self) -> None:
        """One short profiled stretch in set-up: the first start of the
        profiler initialises the card's tracing, which would otherwise eat
        into the traced window."""
        self.start()
        torch.ones(1, device=self.device).add_(1)
        self.stop()
        self._prof = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def stop(self) -> None:
        """End the profiled stretch; its events are read at `read`, which a
        server's run calls once its window has closed (reading them takes
        the interpreter for a while)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()

    def read(self) -> None:
        if self._prof is None:
            return
        for e in self._prof.profiler.kineto_results.events():
            op = (e.name(), int(e.start_ns()), int(e.end_ns()))
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation() and op[0] not in SPANS:
                    self.device_ops.append(op)
            elif e.is_user_annotation():
                self.spans.append(op)
            else:
                self.host.append(op)
        self._prof = None

    def windows(self, name: str) -> List[Tuple[int, int]]:
        """The [start, end) of every harness span called `name`."""
        return [(s, e) for n, s, e in self.spans if n == name]

    def ops(self, lo: int, hi: int, contains: Optional[str] = None) -> List[Op]:
        """Device operations starting in [lo, hi), by a part of their name."""
        return [op for op in self.device_ops
                if lo <= op[1] < hi and (contains is None or contains in op[0])]

    def intervals(self, lo: int, hi: int) -> List[Tuple[int, int]]:
        return [(s, e) for _, s, e in self.device_ops if e > lo and s < hi]

    def busy_ns(self, lo: int, hi: int) -> float:
        return stats.busy(self.intervals(lo, hi), lo, hi)

    def breakdown(self, lo: int, hi: int) -> Dict[str, List[List]]:
        """The device operations that took most time in [lo, hi), and the
        idle gaps' seconds by what the host was doing at each gap's middle
        (the innermost harness span and host event there)."""
        by_op: Dict[str, float] = {}
        for name, s, e in self.device_ops:
            if e > lo and s < hi:
                by_op[name] = by_op.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e9
        by_host: Dict[str, float] = {}
        spans = sorted(self.spans, key=lambda x: x[2] - x[1])
        host = sorted(self.host, key=lambda x: x[2] - x[1])
        for g0, g1 in stats.gaps(self.intervals(lo, hi), lo, hi):
            if g1 - g0 < SHORT_GAP_NS:
                by_host[SHORT_LABEL] = by_host.get(SHORT_LABEL, 0.0) + (g1 - g0) / 1e9
                continue
            mid = (g0 + g1) // 2
            outer = next((n for n, s, e in spans if s <= mid < e), "outside any span")
            inner = next((n for n, s, e in host if s <= mid < e), "idle host")
            label = f"{outer} / {inner}"
            by_host[label] = by_host.get(label, 0.0) + (g1 - g0) / 1e9
        return {"device_ops": stats.top(by_op), "idle_gaps": stats.top(by_host)}


@dataclass
class Record:
    """What a per-layer metric's reader reads: the cell, the configuration
    and mix, the harness's counters and the trace (None when the traced
    stretch saw nothing)."""

    workload: dict
    cfg: dict
    mix: dict
    chips: int
    counters: Dict[str, Any] = field(default_factory=dict)
    trace: Optional[Trace] = None
