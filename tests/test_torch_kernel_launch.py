"""The port's native-code layer (ops/kernels/launch.py) and the kernel
wrappers around their launches, on the CPU:

- every `Library` that declares load-time checks (B1, B2, the marks)
  refuses a library whose shared-memory layout is not its plans', that
  lacks a specialised instance its backward plan chooses, or whose names
  are not the module's; one with no checks (the host gather, dropout) just
  loads;
- a `Library` loads once when two threads ask at the same time;
- `launch` runs a function with the tensors' device current and that
  device's current raw stream, raises the shared-memory attribute only
  when a launch asks for more, and raises with the CUDA error's number; a
  mark launches through it;
- B1's and B2's backward launches hand the library their plan's scalars
  and set the shared-memory attribute per kernel (the specialised instance,
  the general one), only ever raising it;
- `ImplicitAttention.backward` and `GraphAttention.backward` route a
  cotangent on the card to the backward kernel and one on the CPU to the
  transcription, between their marks;
- a fake CUDA-graph capture of a step that launches B1 or B2 (forward and
  backward) or calls BAN: the warm-up's and the capture's counts are taken
  back and every replay adds them again, through the counter registry,
  and the benchmark's `launched` reads `graphs.launch_counts()` as before;
- no kernel but B1's and B2's forwards matches the benchmark's matchers;
- the import rules: ops/kernels/ and models/ban.py import nothing from
  train/, B1 does not import B2, train/graphs.py imports neither wrapper,
  and launch.py takes nothing from the package but build.py.
"""

from __future__ import annotations

import ast
import contextlib
import ctypes
import re
import threading
import time
import types
from pathlib import Path

import pytest
import torch

import tf_vqa_regat_tpu_torch
from regat_bench import kernels as bench_kernels
from tf_vqa_regat_tpu_torch.data import native
from tf_vqa_regat_tpu_torch.models import ban
from tf_vqa_regat_tpu_torch.ops.kernels import build, launch, marks
from tf_vqa_regat_tpu_torch.ops.kernels import dropout as kd
from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia
from tf_vqa_regat_tpu_torch.train import graphs, profiling

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

PACKAGE = Path(tf_vqa_regat_tpu_torch.__file__).resolve().parent
LIBRARIES = {"b1": ia.LIB, "b2": ga.LIB, "marks": marks.LIB, "pack": native.LIB,
             "dropout": kd.LIB}


@pytest.fixture(autouse=True)
def _counts():
    """Each test starts from empty counters and leaves them as it found
    them."""
    saved = launch.counts()
    launch.set_counts({})
    yield
    launch.set_counts(saved)


class _Function:
    """A stand-in for a ctypes function: callable, with settable argtypes."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def _fake(library, off=None):
    """A stand-in for `library`'s CDLL: every function of its table; the
    plans' shared memory as the plans compute it, 16 B more for the plan
    named `off`; its specialised instances compiled in, none with `off` =
    "specialised"; its names the module's, the last one renamed with `off`
    = "names"."""
    fns = {name: _Function(lambda *a: 0) for name in library.functions}
    for what, plan, fn, _ in library.plans:
        fns[fn] = _Function(lambda *s, plan=plan, e=16 * (off == what): plan(*s) + e)
    if library.specialised is not None:
        fn, _, instances = library.specialised
        fns[fn] = _Function(lambda *i: int(i in instances and off != "specialised"))
    if library.names is not None:
        count, name, names = library.names
        names = names[:-1] + ("regat_span_renamed",) if off == "names" else names
        fns[count] = _Function(lambda: len(names))
        fns[name] = _Function(lambda i: names[i].encode())
    return types.SimpleNamespace(**fns)


LOAD_CASES = ([(k, off, error) for k in ("b1", "b2") for off, error in (
    (None, None), ("tiling plan", "tiling plan and kernel disagree on shared memory"),
    ("backward plan", "backward plan and kernel disagree on shared memory"),
    ("specialised", "no specialised instance"))]
    + [("marks", None, None), ("marks", "names", "has the marks"), ("pack", None, None),
       ("dropout", None, None)])


@pytest.mark.parametrize("which, off, error", LOAD_CASES)
def test_libraries_are_held_to_their_kernels_at_load(which, off, error, monkeypatch):
    """A kernel edited without its plan, a plan that chooses an instance
    the source lacks, or a mark table out of step with the module never
    launches: `load()` refuses the library. Each check is data of the
    library's table."""
    library = LIBRARIES[which]
    fake = _fake(library, off)
    monkeypatch.setattr(library, "_handle", None)
    monkeypatch.setattr(build, "load", lambda source: fake if source == library.source else None)
    if error is None:
        assert library.load() is fake
        for name, (argtypes, restype) in library.functions.items():
            assert getattr(fake, name).argtypes == list(argtypes)
            assert getattr(fake, name).restype is restype
    else:
        with pytest.raises(RuntimeError, match=error):
            library.load()
        assert library._handle is None


def test_a_library_loads_once_when_two_threads_ask(monkeypatch):
    """The host path's copy thread and the main thread may both reach the
    gather first: one build and load, one handle for both."""
    loads, gate = [], threading.Barrier(2)

    def slow_load(source):
        loads.append(source)
        time.sleep(0.05)
        return types.SimpleNamespace(regat_gather_rows=_Function(None))

    monkeypatch.setattr(build, "load", slow_load)
    library = launch.Library(native.SOURCE, native.LIB.functions)
    got = []

    def ask():
        gate.wait()
        got.append(library.load())

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert loads == [native.SOURCE] and len(got) == 2 and got[0] is got[1]


def _fake_card(monkeypatch, current=0):
    """torch.cuda's current device, its device switch and the raw streams
    (each device's stream handle is 100 + its index), on a CPU build."""
    state = {"current": current}

    @contextlib.contextmanager
    def device(index):
        before, state["current"] = state["current"], index
        try:
            yield
        finally:
            state["current"] = before

    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 100 + index,
                        raising=False)
    return state


def test_launch_runs_on_the_tensors_device_and_stream(monkeypatch):
    state = _fake_card(monkeypatch)
    calls, set_smem = [], []
    lib = types.SimpleNamespace(
        fwd=lambda *a: calls.append((a, state["current"])) or 0,
        set_smem=lambda *a: set_smem.append((a, state["current"])) or 0)
    library = launch.Library(Path("kernel.cu"), {})
    monkeypatch.setattr(library, "load", lambda: lib)
    for index, nbytes in ((1, 4096), (1, 1024), (0, 1024), (1, 8192)):
        library.launch("kernel", "fwd", torch.device("cuda", index), 7, smem=("set_smem", nbytes))
    library.launch("kernel", "fwd", torch.device("cuda"), 8)  # no index: the current one
    assert calls == [((7, 101), 1), ((7, 101), 1), ((7, 100), 0), ((7, 101), 1),
                     ((8, 100), 0)]
    # per device, only raised
    assert set_smem == [((4096,), 1), ((1024,), 0), ((8192,), 1)]
    assert state["current"] == 0


@pytest.mark.parametrize("refused", ["launch", "shared memory"])
def test_launch_raises_with_the_cuda_error(refused, monkeypatch):
    _fake_card(monkeypatch)
    lib = types.SimpleNamespace(fwd=lambda *a: 700 if refused == "launch" else 0,
                                set_smem=lambda *a: 1 if refused != "launch" else 0)
    library = launch.Library(Path("kernel.cu"), {})
    monkeypatch.setattr(library, "load", lambda: lib)
    error = ("B9 kernel launch failed: CUDA error 700" if refused == "launch"
             else "B9 kernel: 4096 B of shared memory refused: CUDA error 1")
    with pytest.raises(RuntimeError, match=error):
        library.launch("B9 kernel", "fwd", torch.device("cuda", 0), smem=("set_smem", 4096))


def test_a_mark_launches_through_the_library(monkeypatch):
    state = _fake_card(monkeypatch)
    launched = []
    monkeypatch.setattr(marks.LIB, "load", lambda: types.SimpleNamespace(
        regat_mark=lambda i, stream: launched.append((i, stream, state["current"])) or 0))
    with marks.recording() as names:
        marks.mark("b2_backward_end", torch.device("cuda", 1))
        marks.mark("ban_forward_begin", "cuda")
    assert names == []  # a mark on CUDA is a kernel, not a name
    assert launched == [(marks.MARKS.index("b2_backward_end"), 101, 1),
                        (len(marks.MARKS), 100, 0)]


def _fake_library(monkeypatch, library):
    """Point `library` at a stand-in that records each launch's arguments
    and each shared-memory attribute it sets; CPU tensors stand in for the
    card's."""
    launched, set_smem = [], []
    lib = types.SimpleNamespace(**{name: (lambda *a, n=name: (set_smem if "set_smem" in n
                                                               else launched).append(a) or 0)
                                   for name in library.functions})
    monkeypatch.setattr(library, "load", lambda: lib)
    monkeypatch.setattr(library, "_smem", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor's index
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda _index: 0, raising=False)
    return launched, set_smem


def _b1_backward_launches(launched):
    """B1: (b, R, n, H, dh, P) -> (the launch's scalars, the plan's)."""
    shapes = [(2, 100, 12, 8, 128, 32),  # general, 137,200 B
              (2, 36, 7, 16, 64, 64),  # general, 122,208 B: less
              (2, 100, 36, 8, 64, 64),  # general, 187,600 B: more
              (2, 100, 20, 12, 64, 64),  # general, 119,952 B: less
              (2, 100, 20, 16, 64, 64)]  # specialised, 213,904 B
    for b, R, n, H, dh, P in shapes:
        ia.KERNEL.backward(torch.zeros(b, R, H, dh), torch.zeros(b, R, H, dh),
                           torch.zeros(b, n, H, dh), torch.zeros(b, n, H, dh),
                           torch.zeros(b, R, n, 4), torch.zeros(b, n), None, 1.0,
                           torch.ones(b, R, H, n), torch.zeros(b, R), P)
    got = []
    for args in launched:
        a = ctypes.cast(args[-2], ctypes.POINTER(ia._BwdLaunch)).contents
        got.append((a.b, a.R, a.n, a.H, a.dh, a.P, a.hb, a.rows, a.chunks, a.smem))
    plans = [ia.backward_plan(b, R, n, H, dh, dh, P) for b, R, n, H, dh, P in shapes]
    return got, [(*s, p.heads, p.rows, p.chunks, p.smem_bytes) for s, p in zip(shapes, plans)]


def _b2_backward_launches(launched):
    """B2: the bias's strides and whether it is shared across heads, the
    softmax mode and the workspaces a launch is handed (a shared bias's
    head-group sums with several groups, dK and dVW's chunk sums with
    several chunks), dbias in the bias's head layout."""
    # (b, R, n, H, dh, o, bias shape, v1)
    cases = [(2, 100, 12, 8, 128, 128, "shared", False),  # general, 62,272 B
             (2, 36, 7, 16, 64, 64, "per_head", True),  # general, 54,208 B: less
             (3, 100, 36, 8, 64, 64, "shared", False),  # general, 65,856 B: more
             (256, 100, 20, 12, 64, 64, "shared", False),  # specialised, 88,640 B
             (256, 100, 20, 16, 64, 64, "shared", False),  # specialised again
             (256, 100, 20, 16, 64, 64, "rows", False)]  # [b, 1, 1, n]: shared, sr = 0
    want = []
    for b, R, n, H, dh, o, kind, v1 in cases:
        bias = torch.zeros({"shared": (b, R, 1, n), "per_head": (b, R, H, n),
                            "rows": (b, 1, 1, n)}[kind])
        dq, dk, dvw, dbias = ga.KERNEL.backward(
            torch.zeros(b, R, H, o), torch.zeros(b, R, H, dh), torch.zeros(b, n, H, dh),
            torch.zeros(b, n, H, o), bias, None if v1 else torch.zeros(b, R), v1)
        assert dq.shape == (b, R, H, dh) and dk.shape == (b, n, H, dh)
        assert dvw.shape == (b, n, H, o)
        assert dbias.shape == (b, R, H if kind == "per_head" else 1, n)
        p = ga.backward_plan(b, R, n, H, dh, o)
        strides = {"shared": (R * n, n, 0), "per_head": (R * H * n, H * n, n),
                   "rows": (n, 0, 0)}[kind]
        shared = kind != "per_head"
        ws = (p.chunks > 1, p.chunks > 1, shared and H > p.heads)
        want.append(((*strides, int(shared), b, R, n, H, dh, o, p.heads, p.rows, p.chunks,
                      p.smem_bytes), int(v1), ws))
    got = []
    for args in launched:
        a = ctypes.cast(args[-3], ctypes.POINTER(ga._BwdLaunch)).contents
        ws = tuple(p is not None for p in args[10:13])  # ws_k, ws_v, ws_b
        got.append(((a.sb, a.sr, a.sh, a.shared, a.b, a.R, a.n, a.H, a.dh, a.o, a.hb,
                     a.rows, a.chunks, a.smem), args[-2], ws))
    return got, want


BACKWARD_LAUNCHES = {
    "b1": (_b1_backward_launches, [(4, 12, 128, 32, 137_200), (4, 36, 64, 64, 187_600),
                                   (8, 20, 64, 64, 213_904)]),
    "b2": (_b2_backward_launches, [(2, 12, 128, 128, 62_272), (2, 36, 64, 64, 65_856),
                                   (4, 20, 64, 64, 88_640)]),
}


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_backward_launch_passes_its_plan_and_shared_memory_per_kernel(kernel, monkeypatch):
    """A launch hands the library its plan's scalars; the shared-memory
    attribute is set per kernel (the specialised instance, the general one)
    and only ever raised, since the general instance's serves every shape
    it runs; each launch counts once, under "backward"."""
    module = {"b1": ia, "b2": ga}[kernel]
    launched, set_smem = _fake_library(monkeypatch, module.LIB)
    run, want_smem = BACKWARD_LAUNCHES[kernel]
    got, want = run(launched)
    assert got == want
    assert set_smem == want_smem
    assert sum(n for (v, _), n in module.COUNTS.items() if v == "backward") == len(want)


def _route(kernel, device, needs_bias_grad, monkeypatch):
    """(the Function's output, the calls made, the marks made, the saved
    tensors, the grads the stand-ins return) of one backward."""
    b, R, H, d, n, P = 2, 3, 4, 8, 5, 64
    q, k, vw = torch.zeros(b, R, H, d), torch.zeros(b, n, H, d), torch.zeros(b, n, H, d)
    if kernel == "b1":
        module, transcription = ia, "implicit_attention_backward"
        saved = dict(q=q, k=k, vw=vw, pos_mat=torch.zeros(b, R, n, 4), w_pos=torch.zeros(P, H),
                     mrow=torch.zeros(b, n), keep=None, pwr=torch.ones(b, R, H, n),
                     rowmax=torch.zeros(b, R))
        grads = tuple(torch.full((1,), float(i)) for i in range(5))
        ctx = types.SimpleNamespace(saved_tensors=tuple(saved.values()), inv_keep=1.25,
                                    has_b_pos=needs_bias_grad)
        function = ia.ImplicitAttention
    else:
        module, transcription = ga, "graph_attention_backward"
        saved = dict(q=q, k=k, vw=vw, bias=torch.zeros(b, R, 1, n), rowmax=torch.zeros(b, R))
        grads = tuple(torch.full((1,), float(i)) for i in range(3)) + (torch.ones(b, R, H, n),)
        ctx = types.SimpleNamespace(saved_tensors=tuple(saved.values()), per_head=False,
                                    needs_input_grad=(True, True, True, needs_bias_grad, False))
        function = ga.GraphAttention
    calls, made = [], []
    monkeypatch.setattr(module.KERNEL, "backward",
                        lambda *args: calls.append(("kernel", args)) or grads)
    monkeypatch.setattr(module, transcription,
                        lambda *args: calls.append(("transcription", args)) or grads)
    monkeypatch.setattr(module, "mark", lambda name, dev: made.append((name, dev.type)))
    cotangent = torch.zeros(b, R, H, d)
    g = (types.SimpleNamespace(device=torch.device("cuda"), contiguous=lambda: cotangent)
         if device == "cuda" else cotangent)
    return function.backward(ctx, g), calls, made, saved, grads, cotangent, P


@pytest.mark.parametrize("kernel, device, needs_bias_grad", [
    ("b1", "cuda", True), ("b1", "cpu", True), ("b1", "cuda", False),
    ("b2", "cuda", True), ("b2", "cpu", True), ("b2", "cuda", False), ("b2", "cpu", False)])
def test_backward_routes_by_device(kernel, device, needs_bias_grad, monkeypatch):
    """A cotangent on the card goes to the backward kernel with the row
    maxima the forward kept (B1: and P from the pos-FC kernel), one on the
    CPU to the transcription of the JAX backward (`_fused_v3_bwd`,
    `_fused_bwd`); both between the kernel's marks; a bias gradient only
    where the bias takes one (B2: summed to the bias's shape)."""
    out, calls, made, saved, grads, cotangent, P = _route(kernel, device, needs_bias_grad,
                                                          monkeypatch)
    assert made == [(f"{kernel}_backward_begin", device), (f"{kernel}_backward_end", device)]
    ((route, args),) = calls
    assert route == ("kernel" if device == "cuda" else "transcription")
    assert args[0] is cotangent
    if kernel == "b1":
        assert out == (*grads[:3], None, grads[3], grads[4] if needs_bias_grad else None,
                       None, None, None)
        if device == "cuda":
            assert args[-1] == P and args[7] == 1.25
            assert args[-2] is saved["rowmax"] and args[-3] is saved["pwr"]
        else:
            assert args[5] is saved["w_pos"] and args[-1] is saved["pwr"]
    else:
        assert out[:3] == grads[:3] and out[4] is None
        if needs_bias_grad:
            assert torch.equal(out[3], grads[3].sum_to_size(saved["bias"].shape))
        else:
            assert out[3] is None
        assert args[4] is saved["bias"] and args[-1] is False
        if device == "cuda":
            assert args[5] is saved["rowmax"]
        else:
            assert len(args) == 6


class _FakeGraph:
    def register_generator_state(self, g):
        pass

    def capture_begin(self, **kw):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _FakeStream:
    def wait_stream(self, other):
        pass


def _step_b1(*_):
    b, R, n, H, d, P = 2, 100, 20, 4, 8, 32
    q, k = torch.zeros(b, R, H, d), torch.zeros(b, n, H, d)
    x = (q, k, k, torch.zeros(b, R, n, 4), torch.zeros(P, H), None,
         torch.ones(b, n, dtype=torch.bool))
    with torch.no_grad():
        _, pwr, rowmax = ia.KERNEL(*x, 0.0, None, save_pwr=True)
        ia.KERNEL.backward(q, q, k, k, x[3], torch.zeros(b, n), None, 1.0, pwr, rowmax, P)
    return q


def _step_b2(*_):
    b, R, n, H, d = 2, 100, 20, 4, 8
    q, k, bias = torch.zeros(b, R, H, d), torch.zeros(b, n, H, d), torch.zeros(b, R, 1, n)
    with torch.no_grad():
        _, rowmax = ga.KERNEL(q, k, k, bias, save_max=True)
        ga.KERNEL.backward(q, q, k, k, bias, rowmax)
    return q


def _step_ban(*_):
    module = ban.BAN(8, 6, 2, torch.Generator().manual_seed(0)).train()
    return module(torch.zeros(2, 5, 8), torch.zeros(2, 3, 6),
                  torch.ones(2, 5, dtype=torch.bool))[0]


# (a step, what one replay adds to graphs.launch_counts(), to the benchmark's
# `launched`, to BAN's count)
REPLAYED = {
    "b1": (_step_b1, [({"launches": 0, "train_launches": 1, "backward_launches": 1},
                       {("train", 100): 1}),
                      ({"launches": 0, "per_head_launches": 0, "backward_launches": 0}, {})],
           1, {}),
    "b2": (_step_b2, [({"launches": 0, "train_launches": 0, "backward_launches": 0}, {}),
                      ({"launches": 1, "per_head_launches": 0, "backward_launches": 1},
                       {("v2", 100): 1})], 1, {}),
    "ban": (_step_ban, [({"launches": 0, "train_launches": 0, "backward_launches": 0}, {}),
                        ({"launches": 0, "per_head_launches": 0, "backward_launches": 0}, {})],
            0, {"train": 1}),
}


@pytest.mark.parametrize("what", ["b1", "b2", "ban"])
def test_counts_carry_through_a_replayed_graph(what, monkeypatch):
    """What `_Graph` does around a capture and at each replay, with the
    card's graph and streams stood in for: the warm-up's and the capture's
    launches (or BAN's calls) are taken back, each replay adds the
    capture's again, whatever the counter; the benchmark's sum of B1's and
    B2's forward launches reads the same keys as before."""
    for library in (ia.LIB, ga.LIB):
        _fake_library(monkeypatch, library)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(graphs, "_capture_stream", lambda device: _FakeStream())
    monkeypatch.setattr(profiling, "_SETUP", {})  # the process's set-up totals stay as they are
    step, per_replay, launched, ban_calls = REPLAYED[what]
    before = graphs.launch_counts()
    assert [flat for flat, _ in before] == [
        {"launches": 0, "train_launches": 0, "backward_launches": 0},
        {"launches": 0, "per_head_launches": 0, "backward_launches": 0}]
    inputs = {"x": torch.zeros(3)}
    graph = graphs._Graph(step, "key", inputs, 0, torch.device("cpu"), None, None)
    assert graphs.launch_counts() == before and ban.CALLS == {}
    for replays in (1, 2, 3):
        graph.replay(inputs, ())
        counts = graphs.launch_counts()
        assert counts == [({k: replays * v for k, v in flat.items()},
                           {k: replays * v for k, v in rows.items()})
                          for flat, rows in per_replay]
        assert ban.CALLS == {k: replays * v for k, v in ban_calls.items()}
    assert bench_kernels.launched(graphs.launch_counts()) == 3 * launched


def _global_names(source: str) -> list:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      source)


# (the source's kernels, how the profiler shows a backward kernel's
# instance, the forward's variants as it shows them)
MATCHED = {
    "b1": (["implicit_attention_kernel", "implicit_attention_bwd_kernel",
            "implicit_attention_bwd_reduce"], ("", "EPKfi"),
           ("implicit_attention_kernel<true>", "implicit_attention_kernel<false>")),
    "b2": (["graph_attention_kernel", "graph_attention_bwd_kernel",
            "graph_attention_bwd_reduce"],
           ("<4, 20, 64, 64, false>", "ILi4ELi20ELi64ELi64ELb0EEEvPKfi"),
           ("graph_attention_kernel<false>", "graph_attention_kernel<true>")),
}


@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_backward_kernel_names_escape_the_benchmark_matchers(kernel):
    """The benchmark finds B1's and B2's launches in a trace by name and holds
    them to the launch counters, and reads their rooflines from the
    forward's calls: no kernel of the source but the forward may match."""
    names, (template, mangled), forwards = MATCHED[kernel]
    module = {"b1": ia, "b2": ga}[kernel]
    assert _global_names(module.SOURCE.read_text()) == names
    for name in names[1:]:
        for shown in (name, f"void (anonymous namespace)::{name}{template}(float const*, int)",
                      f"_ZN12_GLOBAL__N_1{len(name)}{name}{mangled}"):
            assert not bench_kernels.is_b1_train(shown)
            assert not bench_kernels.is_b1_eval(shown)
            assert not bench_kernels.is_b2(shown)
    # the forward's variants as the profiler shows them still match
    train, other = (f"void (anonymous namespace)::{v}" for v in forwards)
    if kernel == "b1":
        assert bench_kernels.is_b1_train(train) and bench_kernels.is_b1_eval(other)
    else:
        assert bench_kernels.is_b2(train) and bench_kernels.is_b2(other)


def _imports(path: Path) -> set:
    """The modules `path` imports, and for `from M import N` also M.N."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
            out.update(f"{node.module}.{a.name}" for a in node.names)
    return out


P = "tf_vqa_regat_tpu_torch."
IMPORT_RULES = (
    [(f"ops/kernels/{f.name}", P + "train") for f in sorted((PACKAGE / "ops/kernels").glob("*.py"))]
    + [("models/ban.py", P + "train"),
       ("ops/kernels/implicit_attention.py", P + "ops.kernels.graph_attention"),
       ("train/graphs.py", P + "ops.kernels.implicit_attention"),
       ("train/graphs.py", P + "ops.kernels.graph_attention")])


@pytest.mark.parametrize("path, forbidden", IMPORT_RULES)
def test_import_rules(path, forbidden):
    """The package's arrows point one way: the native-code layer and the
    models never reach up into train/, and the replay bookkeeping knows no
    kernel."""
    assert not [m for m in _imports(PACKAGE / path)
                if m == forbidden or m.startswith(forbidden + ".")]


def test_the_launch_layer_takes_only_build_from_the_package():
    ours = {m for m in _imports(PACKAGE / "ops/kernels/launch.py") if m.startswith(P)}
    assert ours <= {P + "ops.kernels", P + "ops.kernels.build"}
