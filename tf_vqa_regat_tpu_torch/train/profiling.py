"""Tracing hooks of `--mode train` (counterpart of
tf_vqa_regat_tpu/train/profiling.py), both flag-gated:

- `trace_epoch(logdir, epoch)` (--profile_dir): a `torch.profiler` trace
  (CPU and, where CUDA is available, CUDA activities) around the epoch's
  train steps, written as a Chrome trace to
  `{logdir}/epoch_{epoch:04d}/rank{r}.pt.trace.json`; nothing runs when
  `logdir` is empty.
- `annotate(name)`: a `record_function` span. The train loop puts `data`
  around the fetch of each dispatch and `step` around its steps (a block,
  or one host batch), so a timeline shows where the host's time goes.
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

A CUDA-graphed step appears in a trace as a graph launch; the profiler
changes nothing that runs (no step leaves its graph).
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
from typing import Iterator, Optional

import torch

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
