"""Phase marks and span marks: where a train step's phases and a block's
spans begin on the device's clock.

A train step is one CUDA graph replay, and a host range inside it runs at
capture only. A mark is an empty kernel (`csrc/marks.cu`, one per name,
`regat_mark_<name>`) launched <<<1, 1>>> on the current stream, so a capture
takes it into the graph and every replay runs it; the profiler records it
beside the step's other kernels. Every train step, graphed or eager, marks
`gather` (before the batch's gather), then per microbatch `forward` and
`backward`, then under a process group `reduce` (before the gradient sums
are written for the all-reduce), then `optimizer` (before the clip and
Adamax update) and `end` (train/step.py). Inside `backward`, each B1 or B2
backward is bracketed by `b1_backward_begin` / `b1_backward_end`
(`b2_...`). A phase's device time is the device work between its mark and
the next boundary mark (train/profiling.py::phase_ns). Eval steps are not
marked. Off CUDA a mark launches nothing; inside `recording()` its name is
appended to the list it yields (the CPU tests' view of the order).

Span marks. A block that one configuration alone runs brackets its own work
with span marks, launched by `mark` from the same table as kernels named
`regat_span_<name>`: BAN's forward (`ban_forward_begin` / `_end`, in train
and eval steps) and its backward (`ban_backward_begin` / `_end`,
models/ban.py). Their prefix is not the phase marks', so a reader that
parses a step's phase marks passes over them.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Iterator, List

import torch

from tf_vqa_regat_tpu_torch.ops.kernels import build, launch

# in csrc/marks.cu's order (checked when it loads)
MARKS = ("gather", "forward", "backward", "reduce", "optimizer", "end",
         "b1_backward_begin", "b1_backward_end", "b2_backward_begin", "b2_backward_end")
MARK_PREFIX = "regat_mark_"
# the marks that end one phase and open the next, and the phases they open
BOUNDARIES = ("gather", "forward", "backward", "reduce", "optimizer", "end")
PHASES = BOUNDARIES[:-1]
# the bracketed spans inside `backward`
PAIRS = ("b1_backward", "b2_backward")
# the span marks (module docstring)
SPAN_MARKS = ("ban_forward_begin", "ban_forward_end", "ban_backward_begin", "ban_backward_end")
SPAN_PREFIX = "regat_span_"
# every mark's kernel, in csrc/marks.cu's order (checked when it loads)
KERNELS = (tuple(MARK_PREFIX + n for n in MARKS)
           + tuple(SPAN_PREFIX + n for n in SPAN_MARKS))
_INDEX = {name: i for i, name in enumerate(MARKS + SPAN_MARKS)}
_RECORDING: List[List[str]] = []

LIB = launch.Library(
    build.CSRC_DIR / "marks.cu",
    {"regat_mark": ([ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
     "regat_mark_count": ([], ctypes.c_int),
     "regat_mark_name": ([ctypes.c_int], ctypes.c_char_p)},
    names=("regat_mark_count", "regat_mark_name", KERNELS))


def mark(name: str, device: torch.device) -> None:
    """Phase mark or span mark `name` (one of MARKS or SPAN_MARKS) on
    `device`'s current stream: a kernel on CUDA (captured into a graph being
    captured), else nothing but its name in the lists of the open
    `recording()`s."""
    i = _INDEX.get(name)
    if i is None:
        raise ValueError(f"no phase mark or span mark {name!r}; the marks are "
                         f"{MARKS + SPAN_MARKS}")
    device = torch.device(device)
    if device.type != "cuda":
        for names in _RECORDING:
            names.append(name)
        return
    LIB.launch(f"mark {name}", "regat_mark", device, i)


@contextlib.contextmanager
def recording() -> Iterator[List[str]]:
    """The names of the marks made off CUDA while it is open, in order."""
    names: List[str] = []
    _RECORDING.append(names)
    try:
        yield names
    finally:
        _RECORDING.remove(names)
