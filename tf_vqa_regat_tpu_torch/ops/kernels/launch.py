"""The port's native-code layer: how a C source of the package becomes a
loaded library whose functions are checked, launched and counted, and the
rules that cut a kernel's launch on the card. Every native library of the
port goes through it: B1 and B2 (implicit_attention.py, graph_attention.py),
the marks (marks.py) and the host row gather (data/native.py).

- `Library(source, functions, ...)`: `source` built by build.py (nvcc for a
  `.cu`, g++ for a `.cc`) and loaded once, at the first `load()`, under a
  lock: the host path's copy thread and the main thread both reach the
  gather. `functions` is the table of its functions' signatures. The
  load-time checks are data too: the specialised instances the plans choose
  must be the source's, each plan's shared memory must be the kernel's at
  the probe shapes listed, and a table of names must be the module's. A
  library that fails them never launches.
- `Library.launch(what, fn, device, *args)`: `fn(*args, stream)` with
  `device` current and its current raw stream, after raising the kernel's
  dynamic shared-memory attribute where asked (a grow-only cache per
  device, function and specialised instance); a CUDA error raises
  `RuntimeError("<what> launch failed: CUDA error N")`.
- `check_tensors`: the dtype, device, layout and alignment checks of the
  kernels' entry points.
- Planning: the card's constants, `TilingPlan` and `chunk_rows` (a forward
  launch's rows per block), `BackwardPlan`, `heads_per_block` and
  `backward_chunks` (a backward launch's cut).
- Counting: `counter(name)`, a `collections.Counter` registered under
  `name` (B1's "b1" by (variant, query rows R), B2's "b2" the same way,
  BAN's forward calls "ban" by "train" / "eval"). A wrapper counts in
  Python, which a CUDA-graph replay does not run: train/graphs.py snapshots
  every registered counter around a capture (`counts`, `set_counts`) and
  adds the capture's delta at each replay (`add_counts`), whatever the
  counters count.
"""

from __future__ import annotations

import collections
import ctypes
import threading
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from tf_vqa_regat_tpu_torch.ops.kernels import build

# An H100 SXM: the SMs a launch aims to fill, and the dynamic shared memory
# one block may use.
SMS = 132
SMEM_LIMIT = 232_448


def up4(x: int) -> int:
    return -(-x // 4) * 4


class TilingPlan(NamedTuple):
    """How one launch cuts the work: a block per `rows` query rows of one
    example (a grid of `grid` = (chunks per example, b) blocks), and the
    dynamic shared memory each block takes."""

    rows: int
    grid: tuple[int, int]
    smem_bytes: int


def chunk_rows(b: int, R: int) -> int:
    """Query rows per block for b examples of R rows, where each block stages
    its example's K and VW once, so the fewer blocks per example the better,
    as long as SMS blocks or more are in flight: the chunk starts at
    R / ceil(SMS / b) rows and shrinks until the grid holds SMS blocks, but
    never below 8 rows (at R=100: a whole example at b=256, 34 rows at b=64,
    20 at b=32, 8 at b <= 8). B1's and B2's forward plans take it."""
    rows = min(R, max(8, -(-R // -(-SMS // b))))
    while rows > 8 and b * -(-R // rows) < SMS:
        rows -= 1
    return rows


def tiling(b: int, R: int, smem: int) -> TilingPlan:
    """A forward launch's plan: `chunk_rows` rows per block, `smem` bytes of
    shared memory each."""
    rows = chunk_rows(b, R)
    return TilingPlan(rows, (-(-R // rows), b), smem)


class BackwardPlan(NamedTuple):
    """How one backward launch cuts the work: a block per (example, group of
    `heads` heads, chunk of `rows` query rows), a grid of `grid` = (head
    groups x `chunks`, b) blocks, and the dynamic shared memory each block
    takes."""

    heads: int
    rows: int
    chunks: int
    grid: tuple[int, int]
    smem_bytes: int


def heads_per_block(H: int, widths: tuple, specialised: Sequence[tuple],
                    fits: Callable[..., bool]) -> Optional[int]:
    """A backward block's heads: those of a specialised instance (heads,
    *widths) whose heads divide H, else the most of 8, 4, 2 and 1 that
    divides H and `fits(heads, *widths)`; None where none fits."""
    hb = next((i[0] for i in specialised if i[1:] == widths and H % i[0] == 0), None)
    if hb is None:
        hb = next((h for h in (8, 4, 2, 1) if H % h == 0 and fits(h, *widths)), None)
    return hb


def backward_chunks(b: int, R: int, groups: int, tile: int, blocks_per_sm: int):
    """(tiles per block, row chunks per example) of a backward launch of b x
    groups x chunks blocks that each take whole `tile`-row tiles: the count
    that keeps the estimated time least, waves of SMS x blocks_per_sm
    blocks times the block's tiles plus one for its staging; the fewest
    chunks on a tie. B1's and B2's backward plans take it."""
    tiles, best = -(-R // tile), None
    for per_chunk in range(tiles, 0, -1):  # tiles per block; fewer chunks first
        chunks = -(-tiles // per_chunk)
        cost = -(-b * groups * chunks // (SMS * blocks_per_sm)) * (per_chunk + 1)
        if best is None or cost < best[0]:
            best = (cost, per_chunk, chunks)
    return best[1:]


def backward_tiling(b: int, R: int, H: int, hb: int, tile: int, blocks_per_sm: int,
                    smem: int) -> BackwardPlan:
    """A backward launch's plan for hb heads a block: `backward_chunks`
    rows per block, `smem` bytes of shared memory each."""
    groups = H // hb
    per_chunk, chunks = backward_chunks(b, R, groups, tile, blocks_per_sm)
    return BackwardPlan(hb, per_chunk * tile, chunks, (groups * chunks, b), smem)


def check_tensors(device: torch.device, items) -> None:
    """Raise unless each (name, tensor or None, dtype, alignment) is that
    dtype on `device` and, where an alignment is given, contiguous and
    aligned to that many bytes (None: any layout, as B2's strided bias)."""
    for name, t, dtype, align in items:
        if t is None:
            continue
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, the kernel takes {dtype} "
                             f"on {device}")
        if align is not None and (not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


Signature = Tuple[Sequence, object]  # (argtypes, restype)


class Library:
    """`source`'s library with the signatures of `functions` (module
    docstring). The load-time checks: `specialised` = (the function that
    says whether an instance is compiled in, the label of its widths in the
    message, the instances), `plans` = ((what, the plan's shared-memory
    function, the kernel's, probe shapes), ...), `names` = (the function
    that counts the library's names, the one that gives name i, the
    module's names)."""

    def __init__(self, source: Path, functions: Dict[str, Signature], *,
                 specialised: Optional[tuple] = None, plans: Sequence[tuple] = (),
                 names: Optional[tuple] = None):
        self.source, self.functions = source, functions
        self.specialised, self.plans, self.names = specialised, plans, names
        self.instances = () if specialised is None else specialised[2]
        self._handle = None
        self._lock = threading.Lock()
        # (device index, attribute function, specialised instance or None) ->
        # the dynamic shared memory allowed
        self._smem: Dict[tuple, int] = {}

    def load(self) -> ctypes.CDLL:
        """The loaded and checked library, built on the first call."""
        if self._handle is None:
            with self._lock:
                if self._handle is None:
                    self._handle = self._checked(build.load(self.source))
        return self._handle

    def _checked(self, lib):
        for name, (argtypes, restype) in self.functions.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = list(argtypes), restype
        if self.specialised is not None:
            fn, label, instances = self.specialised
            for i in instances:
                if not getattr(lib, fn)(*i):
                    raise RuntimeError(f"the backward kernel has no specialised instance for "
                                       f"{label} = {i}, which backward_plan chooses")
        for what, plan, fn, shapes in self.plans:
            for shape in shapes:
                want = getattr(lib, fn)(*shape)
                if plan(*shape) != want:
                    raise RuntimeError(f"{what} and kernel disagree on shared memory "
                                       f"for {shape}: {plan(*shape)} vs {want}")
        if self.names is not None:
            count, name, want = self.names
            got = tuple(getattr(lib, name)(i).decode() for i in range(getattr(lib, count)()))
            if got != want:
                raise RuntimeError(f"csrc/{self.source.name} has the marks {got}, "
                                   f"this module {want}")
        return lib

    def launch(self, what: str, fn: str, device: torch.device, *args,
               smem: Optional[Tuple[str, int]] = None, instance: tuple = ()) -> None:
        """`fn(*args, stream)` on `device` (made current where it is not),
        with the raw handle of its current stream. `smem` = (the function
        that sets the kernel's dynamic shared-memory attribute, the bytes
        this launch takes) is called as set(*instance, bytes) unless a
        launch on this device asked for as much of the same kernel before:
        the specialised instance `instance` names, else the general one,
        whose attribute serves every shape it runs, so it only grows."""
        lib = self.load()
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index != current:
            with torch.cuda.device(index):
                return self.launch(what, fn, device, *args, smem=smem, instance=instance)
        if smem is not None:
            setter, nbytes = smem
            key = (index, setter, instance if instance in self.instances else None)
            if self._smem.get(key, 0) < nbytes:
                err = getattr(lib, setter)(*instance, nbytes)
                if err != 0:
                    raise RuntimeError(f"{what}: {nbytes} B of shared memory refused: "
                                       f"CUDA error {err}")
                self._smem[key] = nbytes
        # the raw handle of the current stream (what `.cuda_stream` gives,
        # without building a Stream object on every call)
        err = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# ---- counting ----------------------------------------------------------------

COUNTERS: Dict[str, collections.Counter] = {}


def counter(name: str) -> collections.Counter:
    """The counter registered under `name`, made at the first call."""
    return COUNTERS.setdefault(name, collections.Counter())


def counts() -> Dict[str, collections.Counter]:
    """Every registered counter, copied."""
    return {name: c.copy() for name, c in COUNTERS.items()}


def set_counts(saved: Dict[str, collections.Counter]) -> None:
    """Every registered counter back to what `saved` (a `counts()`) holds
    for it, or empty."""
    for name, c in COUNTERS.items():
        c.clear()
        c.update(saved.get(name, ()))


def add_counts(delta: Dict[str, collections.Counter]) -> None:
    for name, d in delta.items():
        counter(name).update(d)
