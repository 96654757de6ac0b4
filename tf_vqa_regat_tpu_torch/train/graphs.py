"""Steps as CUDA graphs: how a train, eval, predict, ensemble or serve step
reaches the card (the counterpart of JAX's one dispatched program per step
or per `--train_block` / `--eval_block` block).

`StepGraphs(fn, device)` runs `fn(key, inputs, generators) -> outputs` (a
tensor, or a dict or tuple of tensors) for inputs of a fixed shape per
`key`. On a CUDA device (`graphed`, the default there) the first call for a
key warms the step up on a side stream (the capture stream), as the
`torch.cuda.graph` docs prescribe (the kernels' builds, their shared-memory attributes and
per-shape caches, the allocator, cuBLAS), then captures it into one CUDA
graph; every call, the first included, copies its inputs into the graph's
static input tensors (device to device), re-seeds the step's generators and
replays the graph. A capture that fails raises: there is no eager fallback
on the card. Off the card (the tests ask for the CPU) or with
`graphed=False` the same call runs `fn` eagerly on the caller's tensors,
with generators re-seeded alike, which is how the graphed and eager steps
are held to each other.

What a replay keeps, and what the callers take care of:
- Addresses. A graph reads and writes the tensors it captured: the
  parameters, the Adamax moments and count, the store's tables, its static
  inputs. They are updated in place (`copy_`, `load_state_dict`), never
  rebound, for as long as the graph lives.
- Generators. Each graph has its own, one per microbatch, registered with
  the graph; `manual_seed` before a replay resets its offset, so a replay
  draws what an eager step seeded alike draws.
- State. `keep` (e.g. `Adamax.snapshot`) saves the state the warm-up steps
  change and restores it in place after the capture, so that every step,
  the first one included, is a replay.
- Outputs. A replay overwrites the previous replay's outputs, and the
  graphs of one `StepGraphs` share one memory pool (they never run at the
  same time), so a graph's outputs may also be overwritten by another
  graph's replay. A caller consumes or copies them before the next replay
  of any graph of the pool; a consumer's kernels queue on the same stream,
  so they read the outputs before the next replay writes them.
- Set-up. Each graph's warm-up and capture is a `capture` span; its host
  seconds (`capture_s`) add to train/profiling.py's `capture` total.
- Launch counts. The kernel wrappers count in Python, which a replay does
  not run: every counter registered with ops/kernels/launch.py (the
  kernels' launches, BAN's forward calls) is snapshotted before a warm-up,
  set back after it and after the capture, and the capture's delta is
  added at every replay, so a count is the launches the card ran; a
  warm-up's launches are not counted.
- Captures run in `thread_local` mode: the host path's copy thread and the
  background checkpoint writer go on using the card while a graph is
  captured on the main thread. No garbage collection runs during a
  capture: freeing another graph there would end the capture. A step
  function that refers to its owner (a bound method) makes a reference
  cycle, freed only by the collector, so the owners pass closures over
  what the step reads instead.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.ops.kernels import launch
from tf_vqa_regat_tpu_torch.train import profiling

Inputs = Dict[str, torch.Tensor]
StepFn = Callable[[Hashable, Inputs, List[torch.Generator]], Any]

# eager runs of a step before its capture: one builds the kernels and fills
# every cache a capture may not fill
WARMUP_CALLS = 1

# B1's and B2's counters as the benchmark reads them: per kernel, its
# variants' totals under these names
_VIEW = (("b1", {"eval": "launches", "train": "train_launches", "backward": "backward_launches"}),
         ("b2", {"v2": "launches", "v1": "per_head_launches", "backward": "backward_launches"}))


def launch_counts() -> list:
    """The harness's view of the launch counters (regat_bench/kernels.py):
    for B1 and B2, (its launches by variant, under the names of `_VIEW`; its
    forward launches by (variant, query rows R)), zeros for a kernel not
    launched yet."""
    out = []
    for name, names in _VIEW:
        c = launch.counter(name)
        out.append(({key: sum(n for (v, _), n in c.items() if v == variant)
                     for variant, key in names.items()},
                    collections.Counter({k: n for k, n in c.items() if k[0] != "backward"})))
    return out


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`: through pinned memory and without a host
    sync on the card (a pageable copy would wait for the queued steps)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every warm-up and capture on `device` runs on. It comes
    from torch's pool of high-priority streams, which nothing else in the
    port draws from: the pool hands its streams out in turn, and a capture
    stream shared with the host path's copy stream or the checkpoint
    writer's would capture their work too."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device, priority=-1)
    return _CAPTURE_STREAMS[index]


class _Graph:
    """One captured step: its static inputs, generators, outputs and the
    launch counts one replay adds."""

    def __init__(self, fn: StepFn, key: Hashable, inputs: Inputs, n_generators: int,
                 device: torch.device, pool: Any, keep: Optional[Callable[[], Callable]]):
        t0 = time.perf_counter()
        with profiling.annotate("capture"):
            self._capture(fn, key, inputs, n_generators, device, pool, keep)
        self.capture_s = time.perf_counter() - t0
        profiling.add_setup("capture", self.capture_s)

    def _capture(self, fn: StepFn, key: Hashable, inputs: Inputs, n_generators: int,
                 device: torch.device, pool: Any, keep: Optional[Callable[[], Callable]]):
        """Warm the step up, capture it, restore the state the warm-up changed."""
        self.static = {k: v.detach().clone() for k, v in inputs.items()}
        self.generators = [torch.Generator(device=device) for _ in range(n_generators)]
        restore = keep() if keep is not None else None
        before = launch.counts()
        side = _capture_stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_CALLS):
                for g in self.generators:
                    g.manual_seed(0)
                fn(key, self.static, self.generators)
        torch.cuda.current_stream(device).wait_stream(side)
        launch.set_counts(before)
        self.graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            self.graph.register_generator_state(g)
        # a graph freed during a capture (its destructor frees the executable
        # graph) invalidates the capture: no collection runs until it ends.
        # capture_begin/end as torch.cuda.graph calls them, without its
        # synchronize, collection and empty_cache, which cost each capture
        # a few hundred ms and buy nothing here
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.out = fn(key, self.static, self.generators)
                finally:
                    self.graph.capture_end()
        finally:
            if enabled:
                gc.enable()
        self.delta = {name: c - before.get(name, collections.Counter())
                      for name, c in launch.counts().items()}
        launch.set_counts(before)
        if restore is not None:
            restore()
        torch.cuda.synchronize(device)

    def replay(self, inputs: Inputs, seeds: Sequence[int]) -> Any:
        if inputs.keys() != self.static.keys():
            raise ValueError(f"graph inputs {sorted(inputs)}, captured with {sorted(self.static)}")
        for k, v in inputs.items():
            dst = self.static[k]
            if v.shape != dst.shape or v.dtype != dst.dtype:
                raise ValueError(f"graph input {k}: {v.dtype}{tuple(v.shape)}, captured with "
                                 f"{dst.dtype}{tuple(dst.shape)}")
            dst.copy_(v, non_blocking=True)
        for g, s in zip(self.generators, seeds):
            g.manual_seed(s)
        self.graph.replay()
        launch.add_counts(self.delta)
        return self.out


class StepGraphs:
    """`fn` as one CUDA graph per key (module docstring), or eagerly.

    fn(key, inputs, generators) -> outputs; `generators` is how many
    generators the step draws from (its dropout), re-seeded from `seeds` at
    each call; `keep` saves the state a step changes and returns the
    function that restores it (the warm-up's steps must leave no trace);
    `pool` a memory pool to share with another StepGraphs whose graphs never
    run at the same time as these, by default a new one. `graphed` defaults
    to True on a CUDA device and is refused elsewhere."""

    def __init__(self, fn: StepFn, device: torch.device, graphed: Optional[bool] = None,
                 generators: int = 0, keep: Optional[Callable[[], Callable]] = None,
                 pool: Any = None):
        self.fn, self.device = fn, torch.device(device)
        self.graphed = self.device.type == "cuda" if graphed is None else bool(graphed)
        if self.graphed and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {self.device}")
        self.n_generators, self.keep = generators, keep
        self.pool = (pool if pool is not None or not self.graphed
                     else torch.cuda.graph_pool_handle())
        self._graphs: Dict[Hashable, _Graph] = {}
        self._eager_generators: Optional[List[torch.Generator]] = None

    def __call__(self, key: Hashable, inputs: Inputs, seeds: Sequence[int] = ()) -> Any:
        if len(seeds) != self.n_generators:
            raise ValueError(f"{len(seeds)} seeds for {self.n_generators} generators")
        if not self.graphed:
            if self._eager_generators is None:
                self._eager_generators = [torch.Generator(device=self.device)
                                          for _ in range(self.n_generators)]
            for g, s in zip(self._eager_generators, seeds):
                g.manual_seed(s)
            return self.fn(key, inputs, self._eager_generators)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _Graph(self.fn, key, inputs, self.n_generators,
                                               self.device, self.pool, self.keep)
        return graph.replay(inputs, seeds)

    def capture_seconds(self) -> Dict[Hashable, float]:
        """Seconds each graph took to warm up and capture, by key."""
        return {k: g.capture_s for k, g in self._graphs.items()}
