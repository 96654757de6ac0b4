"""Tracing hooks of the port (counterpart of
tf_vqa_regat_tpu/train/profiling.py):

- `trace_epoch(logdir, epoch)` (--profile_dir): a `torch.profiler` trace
  (CPU and, where CUDA is available, CUDA activities) around the epoch's
  train steps, written as a Chrome trace to
  `{logdir}/epoch_{epoch:04d}/rank{r}.pt.trace.json`; nothing runs when
  `logdir` is empty.
- `annotate(name)`: a host span. The data path puts `data` around the
  assembly of each train block's indices (`_DataPath.train_stream`), the
  train steps `step` around a block's steps and `upload` around its copy
  to the card (`TrainSteps.block`, `TrainSteps.batch`), so a timeline
  shows where the host's time goes. On CUDA the profiler mirrors a span
  onto the device's timeline, stretched over the kernels launched inside
  it and flagged as a user annotation: a reader of device intervals leaves
  such events out (profile_step.py does), or it counts the mirror as
  device work.
- `timed(name)`: a span that also adds its host seconds to a process-wide
  set-up total, `setup_seconds()`: `init` (ReGAT's construction), `upload`
  (a device store's tables), `capture` (a graph's warm-up and capture,
  train/graphs.py, which adds the seconds it measures itself).
- `maybe_start_server(port, default_dir)` (--profile_port): JAX starts
  jax.profiler's live-capture server there. Torch has none, so the port
  serves `GET /capture?duration_ms=N` over HTTP from a daemon thread: the
  request is posted to the train loop, which starts a profiler at its next
  step boundary, stops it at the first boundary N ms later, writes the
  trace under --profile_dir (else `{output}/profile/`) as
  `capture_KKK/rank0.pt.trace.json`, and the reply is
  `{"trace": path, "steps": ..., "ms": ...}`. The profiler starts and
  stops in the loop's thread only; the HTTP thread posts and waits. A
  request that finds an epoch trace running (--profile_dir) is answered
  409, one that no step boundary reaches before training ends 503.

Phase marks and span marks (`mark`, `recording`, the marks' names) live
in ops/kernels/marks.py, beside the kernels they launch; `phase_ns` here
reads a traced stretch of marked steps. BAN's forward calls are counted in
models/ban.py (`CALLS`, replay-aware through train/graphs.py), and
`setup_line(ban=True)` prints them; `setup_line` also prints the dropout
kernel's launches (ops/kernels/dropout.py, counted alike) once it has
launched.

A CUDA-graphed step appears in a trace as a graph launch and its kernels;
the profiler changes nothing that runs (no step leaves its graph).
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import torch

from tf_vqa_regat_tpu_torch.ops.kernels import launch
from tf_vqa_regat_tpu_torch.ops.kernels.marks import BOUNDARIES, MARK_PREFIX, PAIRS, PHASES
from tf_vqa_regat_tpu_torch.parallel import distributed


def trace_name() -> str:
    return f"rank{distributed.rank()}.pt.trace.json"


def _profiler() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _stop(prof: torch.profiler.profile, path: str) -> str:
    """Stop `prof` (after the card's queued work) and write its trace to
    `path`."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return path


# the epoch trace in progress, if any (a capture does not nest inside it)
_EPOCH_TRACE: list = []


@contextlib.contextmanager
def trace_epoch(logdir: Optional[str], epoch: int) -> Iterator[None]:
    if not logdir:
        yield
        return
    prof = _profiler()
    prof.start()
    _EPOCH_TRACE.append(prof)
    try:
        yield
    finally:
        _EPOCH_TRACE.remove(prof)
        _stop(prof, os.path.join(logdir, f"epoch_{epoch:04d}", trace_name()))


def annotate(name: str):
    """Span annotation visible in profiler timelines."""
    return torch.profiler.record_function(name)


# ---- set-up counters ---------------------------------------------------------

_SETUP: Dict[str, List[float]] = {}  # name -> [seconds, calls]


def add_setup(name: str, seconds: float) -> None:
    """Add `seconds` of host time to the set-up total `name`."""
    total = _SETUP.setdefault(name, [0.0, 0])
    total[0] += seconds
    total[1] += 1


@contextlib.contextmanager
def timed(name: str) -> Iterator[None]:
    """A span `name` whose host seconds add to the set-up total `name`."""
    t0 = time.perf_counter()
    try:
        with annotate(name):
            yield
    finally:
        add_setup(name, time.perf_counter() - t0)


def setup_seconds() -> Dict[str, float]:
    """The process's set-up totals so far, in host seconds, by name."""
    return {name: total[0] for name, total in _SETUP.items()}


def setup_calls() -> Dict[str, int]:
    """How many times each set-up total was added to (graphs captured,
    stores uploaded, models built)."""
    return {name: int(total[1]) for name, total in _SETUP.items()}


def setup_line(ban: bool = False) -> str:
    """The operator's reading of the set-up totals; with `ban`, and BAN's
    forward calls so far; and the dropout kernel's launches so far where it
    launched (on the card)."""
    s, n = setup_seconds(), setup_calls()
    line = (f"[setup] model init {s.get('init', 0.0):.3f} s, tables upload "
            f"{s.get('upload', 0.0):.3f} s, warm-up and capture {s.get('capture', 0.0):.3f} s "
            f"({n.get('capture', 0)} graphs)")
    if ban:
        calls = launch.counter("ban")
        line += f"; BAN forward calls: train {calls['train']}, eval {calls['eval']}"
    drops = launch.counter("dropout")
    if drops:
        line += (f"; dropout launches: forward {drops['forward']}, "
                 f"backward {drops['backward']}")
    return line


Op = Tuple[str, int, int]  # name, start ns, end ns


def union_ns(intervals: Iterable[Tuple[int, int]]) -> int:
    """The length of the union of [start, end) intervals."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += max(e - s, 0)
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def phase_ns(ops: Sequence[Op]) -> Tuple[int, Dict[str, int]]:
    """(steps, device-busy ns by phase and bracketed pair) of a stretch of
    device operations holding whole marked steps: a phase's time is the
    union of the operations' intervals (marks among them) between the end
    of its mark and the start of the next boundary mark; a pair's between
    the end of its begin mark and the start of its end mark; steps are the
    `end` marks."""
    marks = sorted(((name[len(MARK_PREFIX):], s, e) for name, s, e in ops
                    if name.startswith(MARK_PREFIX)), key=lambda m: m[1])

    def busy(lo: int, hi: int) -> int:
        return union_ns((max(s, lo), min(e, hi)) for _, s, e in ops if e > lo and s < hi)

    out = {name: 0 for name in PHASES + PAIRS}
    bounds = [m for m in marks if m[0] in BOUNDARIES]
    for (name, _, end), (_, start, _) in zip(bounds, bounds[1:]):
        if name in PHASES:
            out[name] += busy(end, start)
    opened: Dict[str, int] = {}
    for name, start, end in marks:
        pair, _, edge = name.rpartition("_")
        if pair in PAIRS and edge == "begin":
            opened[pair] = end
        elif pair in opened:
            out[pair] += busy(opened.pop(pair), start)
    return sum(1 for m in bounds if m[0] == "end"), out


class _Request:
    def __init__(self, duration_ms: float):
        self.duration_ms = duration_ms
        self.done = threading.Event()
        self.status, self.reply = 503, {"error": "training ended before a step boundary"}


class CaptureServer:
    """The --profile_port endpoint (module docstring). The train loop calls
    `poll()` at every step boundary and `close()` when it ends."""

    def __init__(self, port: int, out_dir: str):
        self.out_dir = out_dir
        self.requests: "queue.Queue[_Request]" = queue.Queue()
        self._active: Optional[tuple] = None  # (request, profiler, t0, steps)
        self._count = 0
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                if url.path != "/capture":
                    return self._json(404, {"error": "GET /capture?duration_ms=N"})
                try:
                    ms = float(urllib.parse.parse_qs(url.query).get("duration_ms", ["1000"])[0])
                except ValueError:
                    return self._json(400, {"error": "duration_ms must be a number"})
                req = _Request(max(ms, 0.0))
                server.requests.put(req)
                if not req.done.wait(timeout=ms / 1000.0 + 3600.0):
                    return self._json(504, {"error": "no step boundary within an hour"})
                self._json(req.status, req.reply)

            def _json(self, status, body):
                data = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        try:
            self.httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        except OSError as e:
            raise RuntimeError(
                f"--profile_port {port}: cannot serve the capture endpoint there ({e}); "
                f"pick a free port, or 0 to turn it off"
            ) from e
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def poll(self, nsteps: int = 0) -> None:
        """At a step boundary, in the loop's thread, after `nsteps` steps
        since the last: stop a capture whose time is up, or start the next
        one requested."""
        if self._active is not None:
            req, prof, t0, steps = self._active
            steps += nsteps
            self._active = (req, prof, t0, steps)
            if (time.perf_counter() - t0) * 1e3 < req.duration_ms:
                return
            self._finish()
        try:
            req = self.requests.get_nowait()
        except queue.Empty:
            return
        if _EPOCH_TRACE:
            req.status, req.reply = 409, {"error": "an epoch trace is running (--profile_dir); "
                                                   "its trace holds these steps"}
            req.done.set()
            return
        prof = _profiler()
        prof.start()
        self._active = (req, prof, time.perf_counter(), 0)

    def _finish(self) -> None:
        req, prof, t0, steps = self._active
        self._active = None
        self._count += 1
        ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(self.out_dir, f"capture_{self._count:03d}", trace_name())
        req.status, req.reply = 200, {"trace": _stop(prof, path), "steps": steps, "ms": ms}
        req.done.set()

    def close(self) -> None:
        """Training ended: write a capture in progress with what it holds,
        answer the requests no boundary reached (503), stop serving."""
        if self._active is not None:
            self._finish()
        while True:
            try:
                self.requests.get_nowait().done.set()
            except queue.Empty:
                break
        self.httpd.shutdown()
        self.httpd.server_close()


def maybe_start_server(port: int, default_dir: str,
                       profile_dir: str = "") -> Optional[CaptureServer]:
    """The capture endpoint on `port` (0: None), writing under
    `profile_dir`, else `default_dir`. Only the primary rank serves; a port
    in use raises, naming --profile_port."""
    if not port or not distributed.is_primary():
        return None
    return CaptureServer(port, profile_dir or default_dir)
