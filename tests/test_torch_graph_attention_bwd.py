"""B2's backward kernel around its launch: the wrapper's `backward_plan` and
shared-memory function at the shapes the forward takes under grad (R = 36,
64 and 100, the roi buckets and the fixed-36 layout; b from 8 to 256, which
--grad_accum and data parallelism divide; H = 4, 8, 12 and 16 heads, dh = o
= 64, n = 20; and the other widths the model's flags give, which run the
general instance), the refusal of untaken shapes before any build, the
launch's scalars (the bias's strides, whether it is shared across heads) and
shared-memory attributes, the forward's row maxima under grad, the routing
of `GraphAttention.backward`, the `backward_launches` counter through a
replayed graph, and the kernels' names against the benchmark's matchers. The
kernel itself runs only on a GPU (chip_smoke.py phases 6 and 27); these
checks need none."""

from __future__ import annotations

import ctypes
import re
import types

import pytest
import torch

from regat_bench import kernels as bench_kernels
from tf_vqa_regat_tpu_torch.ops.kernels import build
from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia
from tf_vqa_regat_tpu_torch.train import graphs

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

SHAPE = dict(n=20, dh=64, o=64)


def _plan(b, R, H, **over):
    s = {**SHAPE, **over}
    return ga.backward_plan(b, R, s["n"], H, s["dh"], s["o"])


@pytest.mark.parametrize("H", [4, 8, 12, 16])
@pytest.mark.parametrize("R", [36, 64, 100])
@pytest.mark.parametrize("b", [8, 32, 64, 256])
def test_backward_plan_covers_every_row_once_and_fits(b, R, H):
    """Every (example, head, row) in exactly one block; the blocks' heads
    divide H; each thread's dK / dVW keys, its dq rows and the block's
    shared memory fit; every H of the configurations' widths runs the
    specialised instance (4 heads a block)."""
    plan = _plan(b, R, H)
    groups = H // plan.heads
    assert groups * plan.heads == H
    assert plan.grid == (groups * plan.chunks, b)
    assert plan.rows % ga.BWD_TILE == 0
    covered = [r for c in range(plan.chunks)
               for r in range(c * plan.rows, min(R, (c + 1) * plan.rows))]
    assert covered == list(range(R))
    assert (plan.chunks - 1) * plan.rows < R  # no empty block
    qc = plan.heads * SHAPE["dh"] // 4
    assert -(-ga.BWD_TILE // (ga.BWD_THREADS // qc)) <= ga.BWD_MAX_ROWS_D
    assert -(-SHAPE["n"] // (ga.BWD_THREADS // 2 // qc)) <= ga.BWD_MAX_KEYS
    assert (plan.heads, SHAPE["n"], SHAPE["dh"], SHAPE["o"]) in ga.BWD_SPECIALISED
    assert plan.smem_bytes == ga.bwd_smem_bytes(plan.heads, SHAPE["dh"], SHAPE["n"],
                                                SHAPE["o"]) <= ga.BWD_SMEM_LIMIT


# (H, n, dh, o, heads per block) at widths the model's flags give: the
# configuration's; 12 heads; relation_dim 1024 over 8 and 4 heads and 512
# over 16; nongt_dim 36, 50, 10 and 12, and roi buckets of 16 and 7 below it
# (n = R); a value width other than the head's
FLAG_WIDTHS = [(16, 20, 64, 64, 4), (12, 20, 64, 64, 4), (8, 20, 128, 128, 2),
               (4, 20, 256, 256, 1), (16, 20, 32, 32, 8), (8, 36, 64, 64, 2),
               (4, 50, 64, 64, 1), (16, 10, 64, 64, 4), (8, 12, 128, 128, 2),
               (16, 16, 64, 64, 4), (16, 7, 64, 64, 4), (16, 20, 64, 32, 4),
               (4, 20, 32, 96, 2)]


@pytest.mark.parametrize("H, n, dh, o, heads", FLAG_WIDTHS)
def test_backward_blocks_fit_registers_and_shared_memory(H, n, dh, o, heads):
    """At each width: the plan's heads a block, whose dq rows, dK / dVW keys
    and (head, key) items a thread keeps fit the kernel's registers and
    threads, and whose layout fits a block's shared memory (two blocks an
    SM); the configurations' (n, dh, o) alone run the specialised
    instance."""
    plan = ga.backward_plan(256, 100, n, H, dh, o)
    hb = plan.heads
    assert hb == heads and H % hb == 0
    qc, gc = hb * dh // 4, hb * o // 4  # (head, 4 channels) of a q and a g row
    half = ga.BWD_THREADS // 2
    assert max(qc, gc) <= half
    assert -(-ga.BWD_TILE // (ga.BWD_THREADS // qc)) <= ga.BWD_MAX_ROWS_D
    assert max(-(-n // (half // qc)), -(-n // (half // gc))) <= ga.BWD_MAX_KEYS
    assert plan.smem_bytes == ga.bwd_smem_bytes(hb, dh, n, o) <= ga.BWD_SMEM_LIMIT
    assert ga.BWD_BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= 233_472
    assert ((hb, n, dh, o) in ga.BWD_SPECIALISED) == ((n, dh, o) == (20, 64, 64))


def test_backward_plan_at_the_model_shapes():
    """spatial's b=256 step: 4 heads and the whole example per block (four
    blocks per example, two an SM), 88,640 B of shared memory; smaller
    batches cut the rows so that the card fills; the roi buckets; 12 and 8
    heads; dh = 128 runs 2 heads a block."""
    assert tuple(_plan(256, 100, 16)) == (4, 104, 1, (4, 256), 88_640)
    assert tuple(_plan(64, 100, 16)) == (4, 104, 1, (4, 64), 88_640)
    assert tuple(_plan(32, 100, 16)) == (4, 56, 2, (8, 32), 88_640)
    assert tuple(_plan(8, 100, 16)) == (4, 16, 7, (28, 8), 88_640)
    assert tuple(_plan(256, 64, 16)) == (4, 64, 1, (4, 256), 88_640)
    assert tuple(_plan(256, 36, 16)) == (4, 40, 1, (4, 256), 88_640)
    assert tuple(_plan(256, 100, 8)) == (4, 104, 1, (2, 256), 88_640)
    assert tuple(_plan(256, 100, 12)) == (4, 104, 1, (3, 256), 88_640)
    assert tuple(_plan(256, 100, 8, dh=128, o=128)) == (2, 104, 1, (4, 256), 81_216)


def _no_build(monkeypatch):
    def no_build(*_):
        raise AssertionError("the kernel was built for a shape it does not take")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)


@pytest.mark.parametrize("over", [dict(dh=6, o=6), dict(o=10), dict(n=400),
                                  dict(dh=2048, o=2048), dict(n=0)])
def test_untaken_backward_shapes_raise_before_any_build(over, monkeypatch):
    """dh or o not a multiple of 4, more keys than the threads' registers
    hold, a head wider than the dq threads, no keys."""
    _no_build(monkeypatch)
    with pytest.raises(ValueError):
        _plan(2, 3, 4, **over)
    s = {**SHAPE, **over}
    b, R, H, n = 2, 3, 4, s["n"]
    args = (torch.zeros(b, R, H, s["o"]), torch.zeros(b, R, H, s["dh"]),
            torch.zeros(b, n, H, s["dh"]), torch.zeros(b, n, H, s["o"]),
            torch.zeros(b, R, 1, n), torch.zeros(b, R))
    with pytest.raises(ValueError):
        ga._Kernel().backward(*args)


def test_v2_backward_needs_the_row_maxima(monkeypatch):
    _no_build(monkeypatch)
    b, R, H, n, d = 2, 3, 4, 5, 8
    args = (torch.zeros(b, R, H, d), torch.zeros(b, R, H, d), torch.zeros(b, n, H, d),
            torch.zeros(b, n, H, d), torch.zeros(b, R, 1, n), None)
    with pytest.raises(ValueError, match="row maxima"):
        ga._Kernel().backward(*args)


class _Function:
    def __init__(self, fn=None):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def test_the_backward_plan_is_held_to_the_kernel_layout_at_load(monkeypatch):
    """`_Kernel.lib()` refuses a library whose backward shared-memory layout
    is not the backward plan's, or that lacks a specialised instance the
    plan chooses."""

    def fake_lib(extra, missing):
        return types.SimpleNamespace(
            regat_graph_attention_fwd=_Function(),
            regat_graph_attention_set_smem=_Function(),
            regat_graph_attention_smem_bytes=_Function(ga.smem_bytes),
            regat_graph_attention_bwd=_Function(),
            regat_graph_attention_bwd_set_smem=_Function(),
            regat_graph_attention_bwd_smem_bytes=_Function(
                lambda *s: ga.bwd_smem_bytes(*s) + extra),
            regat_graph_attention_bwd_specialised=_Function(
                lambda *i: int(i in ga.BWD_SPECIALISED and not missing)),
        )

    for extra, missing, error in ((0, False, None),
                                  (16, False, "backward plan and kernel disagree"),
                                  (0, True, "no specialised instance")):
        monkeypatch.setattr(build, "load", lambda _source, e=extra, m=missing: fake_lib(e, m))
        kernel = ga._Kernel()
        if error is None:
            assert kernel.lib() is not None
        else:
            with pytest.raises(RuntimeError, match=error):
                kernel.lib()


def _fake_launches(monkeypatch, kernel):
    """Point `kernel` at a library that records each launch's scalars, its
    softmax mode and which workspaces it was handed, and each shared-memory
    attribute it sets; CPU tensors stand in for the card's."""
    launched, set_smem = [], []

    def bwd(*args):
        a = ctypes.cast(args[-3], ctypes.POINTER(ga._BwdLaunch)).contents
        ws = tuple(p is not None for p in args[10:13])  # ws_k, ws_v, ws_b
        launched.append(((a.sb, a.sr, a.sh, a.shared, a.b, a.R, a.n, a.H, a.dh, a.o, a.hb,
                          a.rows, a.chunks, a.smem), args[-2], ws))
        return 0

    lib = types.SimpleNamespace(
        regat_graph_attention_bwd=bwd,
        regat_graph_attention_bwd_set_smem=lambda *a: set_smem.append(a) or 0)
    monkeypatch.setattr(kernel, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor's index
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda _index: 0, raising=False)
    return launched, set_smem


def test_backward_launch_passes_its_plan_and_shared_memory_per_kernel(monkeypatch):
    """A launch hands the library its plan's scalars, the bias's strides and
    whether it is shared across heads, and the workspaces it needs (a
    shared bias's head-group sums with several groups, dK and dVW's chunk
    sums with several chunks); dbias comes in the bias's head layout; the
    shared-memory attribute is set per kernel (the specialised instance, the
    general one) and only ever raised."""
    kernel = ga._Kernel()
    launched, set_smem = _fake_launches(monkeypatch, kernel)
    # (b, R, n, H, dh, o, bias shape, v1)
    cases = [(2, 100, 12, 8, 128, 128, "shared", False),  # general, 62,272 B
             (2, 36, 7, 16, 64, 64, "per_head", True),  # general, 54,208 B: less
             (3, 100, 36, 8, 64, 64, "shared", False),  # general, 65,856 B: more
             (256, 100, 20, 12, 64, 64, "shared", False),  # specialised, 88,640 B
             (256, 100, 20, 16, 64, 64, "shared", False),  # specialised again
             (256, 100, 20, 16, 64, 64, "rows", False)]  # [b, 1, 1, n]: shared, sr = 0
    plans = []
    for b, R, n, H, dh, o, kind, v1 in cases:
        bias = torch.zeros({"shared": (b, R, 1, n), "per_head": (b, R, H, n),
                            "rows": (b, 1, 1, n)}[kind])
        dq, dk, dvw, dbias = kernel.backward(
            torch.zeros(b, R, H, o), torch.zeros(b, R, H, dh), torch.zeros(b, n, H, dh),
            torch.zeros(b, n, H, o), bias, None if v1 else torch.zeros(b, R), v1)
        assert dq.shape == (b, R, H, dh) and dk.shape == (b, n, H, dh)
        assert dvw.shape == (b, n, H, o)
        assert dbias.shape == (b, R, H if kind == "per_head" else 1, n)
        plans.append(ga.backward_plan(b, R, n, H, dh, o))
    want = []
    for (b, R, n, H, dh, o, kind, v1), p in zip(cases, plans):
        strides = {"shared": (R * n, n, 0), "per_head": (R * H * n, H * n, n),
                   "rows": (n, 0, 0)}[kind]
        shared = kind != "per_head"
        ws = (p.chunks > 1, p.chunks > 1, shared and H > p.heads)
        want.append(((*strides, int(shared), b, R, n, H, dh, o, p.heads, p.rows, p.chunks,
                      p.smem_bytes), int(v1), ws))
    assert launched == want
    assert set_smem == [(2, 12, 128, 128, 62_272), (2, 36, 64, 64, 65_856),
                        (4, 20, 64, 64, 88_640)]
    assert kernel.backward_launches == 6


def test_forward_under_grad_keeps_the_row_maxima(monkeypatch):
    """The Function's forward on the card asks the launch for v2's row
    maxima and saves them for the backward; a launch without grad keeps
    none (the eval, serve and predict path is the one it was)."""
    calls = []

    def fwd(*args):
        calls.append(args)
        return 0

    kernel = ga._Kernel()
    monkeypatch.setattr(kernel, "lib", lambda: types.SimpleNamespace(
        regat_graph_attention_fwd=fwd, regat_graph_attention_set_smem=lambda _s: 0))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda _index: 0, raising=False)
    b, R, H, n, d = 2, 3, 4, 5, 8
    x = (torch.zeros(b, R, H, d), torch.zeros(b, n, H, d), torch.zeros(b, n, H, d),
         torch.zeros(b, R, 1, n))
    with torch.no_grad():
        assert kernel(*x).shape == (b, R, H, d)
        out, rowmax = kernel(*x, save_max=True)
        assert rowmax.shape == (b, R)
        assert kernel(*x, True, save_max=True)[1] is None  # v1: its own max per head
    assert [c[5] is None for c in calls] == [True, False, True]
    assert [c[7] for c in calls] == [0, 0, 1]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("needs_bias_grad", [True, False])
def test_backward_routes_by_device(device, needs_bias_grad, monkeypatch):
    """A cotangent on the card goes to the backward kernel with the row
    maxima the forward kept, one on the CPU to the transcription of
    `_fused_bwd`; both between the B2 marks, dbias summed to the bias's
    shape, or None where the bias needs no gradient."""
    b, R, H, d, n = 2, 3, 4, 8, 5
    saved = dict(q=torch.zeros(b, R, H, d), k=torch.zeros(b, n, H, d),
                 vw=torch.zeros(b, n, H, d), bias=torch.zeros(b, R, 1, n),
                 rowmax=torch.zeros(b, R))
    daff = torch.ones(b, R, H, n)
    grads = tuple(torch.full((1,), float(i)) for i in range(3)) + (daff,)
    calls, marks = [], []

    def kernel_backward(*args):
        calls.append(("kernel", args))
        return grads

    def transcription(*args):
        calls.append(("transcription", args))
        return grads

    monkeypatch.setattr(ga.KERNEL, "backward", kernel_backward)
    monkeypatch.setattr(ga, "graph_attention_backward", transcription)
    monkeypatch.setattr(ga, "mark", lambda name, dev: marks.append((name, dev.type)))
    cotangent = torch.zeros(b, R, H, d)
    g = (types.SimpleNamespace(device=torch.device("cuda"), contiguous=lambda: cotangent)
         if device == "cuda" else cotangent)
    ctx = types.SimpleNamespace(saved_tensors=tuple(saved.values()), per_head=False,
                                needs_input_grad=(True, True, True, needs_bias_grad, False))
    out = ga.GraphAttention.backward(ctx, g)
    assert out[:3] == grads[:3] and out[4] is None
    if needs_bias_grad:
        assert torch.equal(out[3], daff.sum_to_size(b, R, 1, n))
    else:
        assert out[3] is None
    assert marks == [("b2_backward_begin", device), ("b2_backward_end", device)]
    ((route, args),) = calls
    assert args[0] is cotangent and args[4] is saved["bias"] and args[-1] is False
    if device == "cuda":
        assert route == "kernel" and args[5] is saved["rowmax"]
    else:
        assert route == "transcription" and len(args) == 6


def test_backward_launches_count_through_a_replayed_graph(monkeypatch):
    """B2's `backward_launches` is one of the counters a graph capture takes
    back and a replay adds again; the benchmark's sum of B1 and B2 launches
    leaves it out."""
    for name in ("launches", "train_launches", "backward_launches"):
        monkeypatch.setattr(ia.KERNEL, name, 0)
    monkeypatch.setattr(ia.KERNEL, "launches_by_rows", ia.KERNEL.launches_by_rows.copy())
    for name in ("launches", "per_head_launches", "backward_launches"):
        monkeypatch.setattr(ga.KERNEL, name, 0)
    monkeypatch.setattr(ga.KERNEL, "launches_by_rows", ga.KERNEL.launches_by_rows.copy())
    before = graphs.launch_counts()
    assert before[1][0] == {"launches": 0, "per_head_launches": 0, "backward_launches": 0}
    # what a captured spatial train step adds: two directions, forward and
    # backward
    ga.KERNEL.launches += 2
    ga.KERNEL.backward_launches += 2
    ga.KERNEL.launches_by_rows["v2", 100] += 2
    delta = graphs._count_delta(graphs.launch_counts(), before)
    graphs._set_counts(before)  # the capture's launches are not counted
    assert ga.KERNEL.backward_launches == 0
    for _ in range(3):  # three replays
        graphs._add_counts(delta)
    counts = graphs.launch_counts()
    assert counts[1][0] == {"launches": 6, "per_head_launches": 0, "backward_launches": 6}
    assert counts[1][1] == {("v2", 100): 6}
    assert bench_kernels.launched(counts) == 6


def _global_names(source: str) -> list:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      source)


def test_backward_kernel_names_escape_the_benchmark_matchers():
    """The benchmark finds B1's and B2's launches in a trace by name and holds
    them to the launch counters, and reads B2's roofline from the forward's
    calls: no kernel of the source but the forward may match."""
    names = _global_names(ga.SOURCE.read_text())
    assert names == ["graph_attention_kernel", "graph_attention_bwd_kernel",
                     "graph_attention_bwd_reduce"]
    for name in names[1:]:
        for shown in (name, f"void (anonymous namespace)::{name}<4, 20, 64, 64, false>"
                            "(float const*, int)",
                      f"_ZN12_GLOBAL__N_1{len(name)}{name}ILi4ELi20ELi64ELi64ELb0EEEvPKfi"):
            assert not bench_kernels.is_b2(shown)
            assert not bench_kernels.is_b1_train(shown)
            assert not bench_kernels.is_b1_eval(shown)
    # the forward's modes as the profiler shows them still match
    assert bench_kernels.is_b2("void (anonymous namespace)::graph_attention_kernel<false>")
    assert bench_kernels.is_b2("void (anonymous namespace)::graph_attention_kernel<true>")
