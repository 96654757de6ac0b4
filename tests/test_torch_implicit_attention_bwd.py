"""B1's backward kernel around its launch: the wrapper's `backward_plan` and
shared-memory function at the shapes the train variant takes (R = 36, 64 and
100, the roi buckets; b from 8 to 256, which --grad_accum and data
parallelism divide; H = 4, 8 and 16 heads, dh = o = 64, n = 20, P = 64; and
the other widths the model's flags give, which run the general instance),
the refusal of untaken shapes before any build, the launch's scalars and
shared-memory attributes, the routing of `ImplicitAttention.backward`, the
`backward_launches` counter through a replayed graph, and the kernels' names
against the benchmark's matchers. The kernel itself runs only on a GPU
(chip_smoke.py phase 26); these checks need none."""

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

SHAPE = dict(n=20, dh=64, o=64, P=64)


def _plan(b, R, H, **over):
    s = {**SHAPE, **over}
    return ia.backward_plan(b, R, s["n"], H, s["dh"], s["o"], s["P"])


@pytest.mark.parametrize("H", [4, 8, 16])
@pytest.mark.parametrize("R", [36, 64, 100])
@pytest.mark.parametrize("b", [8, 32, 64, 256])
def test_backward_plan_covers_every_row_once_and_fits(b, R, H):
    """Every (example, head, row) in exactly one block; the blocks' heads
    divide H; each thread's dK / dVW keys and the block's shared memory fit."""
    plan = _plan(b, R, H)
    groups = H // plan.heads
    assert groups * plan.heads == H and plan.heads <= ia.BWD_MAX_HEADS
    assert plan.grid == (groups * plan.chunks, b)
    assert plan.rows % ia.BWD_TILE == 0
    covered = [r for c in range(plan.chunks)
               for r in range(c * plan.rows, min(R, (c + 1) * plan.rows))]
    assert covered == list(range(R))
    assert (plan.chunks - 1) * plan.rows < R  # no empty block
    # 16 and 8 heads run the specialised instance, 4 the general one
    specialised = (plan.heads, SHAPE["n"], SHAPE["dh"], SHAPE["P"]) in ia.BWD_SPECIALISED
    assert specialised == (H % 8 == 0)
    assert plan.smem_bytes == ia.bwd_smem_bytes(plan.heads, SHAPE["dh"], SHAPE["n"], SHAPE["P"])


# (H, n, dh, P, heads per block) at widths the model's flags give: the
# configuration's; 12 heads; relation_dim 1024 over 8 and 4 heads and 512
# over 16; nongt_dim 36, 50, 12 and 10, and roi buckets of 16 and 7 below
# it (n = R); imp_pos_emb_dim 32, 96 and 128
FLAG_WIDTHS = [(16, 20, 64, 64, 8), (12, 20, 64, 64, 4), (8, 20, 128, 64, 4),
               (4, 20, 256, 64, 2), (16, 20, 32, 64, 8), (8, 36, 64, 64, 4),
               (4, 50, 64, 64, 2), (8, 12, 128, 32, 4), (16, 10, 64, 64, 8),
               (16, 16, 64, 64, 8), (16, 7, 64, 64, 8), (16, 20, 64, 32, 8),
               (4, 20, 32, 96, 4), (16, 20, 64, 128, 4)]


@pytest.mark.parametrize("H, n, dh, P, heads", FLAG_WIDTHS)
def test_backward_blocks_fit_registers_and_shared_memory(H, n, dh, P, heads):
    """At each width: the plan's heads a block, whose dq rows, dK / dVW keys
    and (head, key) items a thread keeps fit the kernel's registers and
    threads, and whose layout fits a block's shared memory; the
    configuration's widths alone run the specialised instance."""
    plan = ia.backward_plan(256, 100, n, H, dh, dh, P)
    hb = plan.heads
    assert hb == heads and H % hb == 0 and hb <= ia.BWD_MAX_HEADS
    qc = hb * dh // 4  # (head, 4 channels) of a q row
    assert -(-ia.BWD_TILE // (ia.BWD_THREADS // qc)) <= ia.BWD_MAX_ROWS_D  # dq rows a thread
    assert -(-n // (ia.BWD_THREADS // 2 // qc)) <= ia.BWD_MAX_KEYS
    assert hb * n <= ia.BWD_THREADS and P % 16 == 0 and P // 16 <= ia.BWD_THREADS // 32
    assert plan.smem_bytes == ia.bwd_smem_bytes(hb, dh, n, P) <= ga.SMEM_LIMIT
    assert ((hb, n, dh, P) in ia.BWD_SPECIALISED) == ((H, n, dh, P) == (16, 20, 64, 64))


def test_backward_plan_at_the_model_shapes():
    """butd's b=256 step: 8 heads and the whole example per block (two
    blocks per example), 213,904 B of shared memory; smaller batches cut the
    rows so that the card fills."""
    assert tuple(_plan(256, 100, 16)) == (8, 104, 1, (2, 256), 213_904)
    assert tuple(_plan(64, 100, 16)) == (8, 104, 1, (2, 64), 213_904)
    assert tuple(_plan(32, 100, 16)) == (8, 56, 2, (4, 32), 213_904)
    assert tuple(_plan(8, 100, 16)) == (8, 16, 7, (14, 8), 213_904)
    assert tuple(_plan(256, 100, 4)) == (4, 104, 1, (1, 256), 119_952)
    assert tuple(_plan(256, 100, 12)) == (4, 104, 1, (3, 256), 119_952)
    # H = 8 at the model's relation_dim 1024: dh = 128, four heads a block
    assert tuple(_plan(256, 100, 8, dh=128, o=128)) == (4, 104, 1, (2, 256), 193_680)


@pytest.mark.parametrize("over", [dict(o=32), dict(dh=6, o=6), dict(P=8), dict(P=272),
                                  dict(P=40), dict(n=200), dict(dh=1024, o=1024), dict(n=0)])
def test_untaken_backward_shapes_raise_before_any_build(over, monkeypatch):
    """dh != o, dh not a multiple of 4, P not a multiple of 16 or over 256,
    more keys than the threads' registers hold, a head wider than the dq
    threads, no keys."""

    def no_build(*_):
        raise AssertionError("the kernel was built for a shape it does not take")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    with pytest.raises(ValueError):
        _plan(2, 3, 4, **over)
    s = {**SHAPE, **over}
    b, R, H, n, P = 2, 3, 4, s["n"], s["P"]
    q = torch.zeros(b, R, H, s["dh"])
    args = (torch.zeros(b, R, H, s["o"]), q, torch.zeros(b, n, H, s["dh"]),
            torch.zeros(b, n, H, s["o"]), torch.zeros(b, R, n, 4), torch.zeros(b, n), None, 1.0,
            torch.zeros(b, R, H, n), torch.zeros(b, R), P)
    with pytest.raises(ValueError):
        ia._Kernel().backward(*args)


def test_the_backward_plan_is_held_to_the_kernel_layout_at_load(monkeypatch):
    """`_Kernel.lib()` refuses a library whose backward shared-memory layout
    is not the backward plan's, or that lacks a specialised instance the
    plan chooses."""

    class Function:
        def __init__(self, fn=None):
            self.fn = fn

        def __call__(self, *args):
            return self.fn(*args)

    def fake_lib(extra, missing):
        return types.SimpleNamespace(
            regat_implicit_attention_fwd=Function(),
            regat_implicit_attention_set_smem=Function(),
            regat_implicit_attention_smem_bytes=Function(ia.smem_bytes),
            regat_implicit_attention_bwd=Function(),
            regat_implicit_attention_bwd_set_smem=Function(),
            regat_implicit_attention_bwd_smem_bytes=Function(
                lambda *s: ia.bwd_smem_bytes(*s) + extra),
            regat_implicit_attention_bwd_specialised=Function(
                lambda *i: int(i in ia.BWD_SPECIALISED and not missing)),
        )

    for extra, missing, error in ((0, False, None),
                                  (16, False, "backward plan and kernel disagree"),
                                  (0, True, "no specialised instance")):
        monkeypatch.setattr(build, "load", lambda _source, e=extra, m=missing: fake_lib(e, m))
        kernel = ia._Kernel()
        if error is None:
            assert kernel.lib() is not None
        else:
            with pytest.raises(RuntimeError, match=error):
                kernel.lib()


def test_backward_launch_passes_its_plan_and_shared_memory_per_kernel(monkeypatch):
    """A launch hands the library its plan's scalars; the shared-memory
    attribute is set per kernel (the specialised instance, the general one)
    and only ever raised, since the general instance's serves every shape
    it runs."""
    launched, set_smem = [], []

    def bwd(*args):
        a = ctypes.cast(args[-2], ctypes.POINTER(ia._BwdLaunch)).contents
        launched.append((a.b, a.R, a.n, a.H, a.dh, a.P, a.hb, a.rows, a.chunks, a.smem))
        return 0

    lib = types.SimpleNamespace(
        regat_implicit_attention_bwd=bwd,
        regat_implicit_attention_bwd_set_smem=lambda *a: set_smem.append(a) or 0)
    kernel = ia._Kernel()
    monkeypatch.setattr(kernel, "lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)  # a CPU tensor's index
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda _index: 0, raising=False)

    shapes = [(2, 100, 12, 8, 128, 32),  # general, 137,200 B
              (2, 36, 7, 16, 64, 64),  # general, 122,208 B: less
              (2, 100, 36, 8, 64, 64),  # general, 187,600 B: more
              (2, 100, 20, 12, 64, 64),  # general, 119,952 B: less
              (2, 100, 20, 16, 64, 64)]  # specialised, 213,904 B
    for b, R, n, H, dh, P in shapes:
        kernel.backward(torch.zeros(b, R, H, dh), torch.zeros(b, R, H, dh),
                        torch.zeros(b, n, H, dh), torch.zeros(b, n, H, dh),
                        torch.zeros(b, R, n, 4), torch.zeros(b, n), None, 1.0,
                        torch.ones(b, R, H, n), torch.zeros(b, R), P)
    plans = [ia.backward_plan(b, R, n, H, dh, dh, P) for b, R, n, H, dh, P in shapes]
    assert launched == [(*s, p.heads, p.rows, p.chunks, p.smem_bytes)
                        for s, p in zip(shapes, plans)]
    assert set_smem == [(4, 12, 128, 32, 137_200), (4, 36, 64, 64, 187_600),
                        (8, 20, 64, 64, 213_904)]
    assert kernel.backward_launches == 5


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_backward_routes_by_device(device, monkeypatch):
    """A cotangent on the card goes to the backward kernel, with the row
    maxima the train variant saved and P from the pos-FC kernel; one on the
    CPU to the transcription of `_fused_v3_bwd`. Both between the B1 marks."""
    b, R, H, d, n, P = 2, 3, 4, 8, 5, 64
    saved = dict(q=torch.zeros(b, R, H, d), k=torch.zeros(b, n, H, d),
                 vw=torch.zeros(b, n, H, d), pos_mat=torch.zeros(b, R, n, 4),
                 w_pos=torch.zeros(P, H), mrow=torch.zeros(b, n), keep=None,
                 pwr=torch.ones(b, R, H, n), rowmax=torch.zeros(b, R))
    grads = tuple(torch.full((1,), float(i)) for i in range(5))
    calls, marks = [], []

    def kernel_backward(*args):
        calls.append(("kernel", args))
        return grads

    def transcription(*args):
        calls.append(("transcription", args))
        return grads

    monkeypatch.setattr(ia.KERNEL, "backward", kernel_backward)
    monkeypatch.setattr(ia, "implicit_attention_backward", transcription)
    monkeypatch.setattr(ia, "mark", lambda name, dev: marks.append((name, dev.type)))
    cotangent = torch.zeros(b, R, H, d)
    g = (types.SimpleNamespace(device=torch.device("cuda"), contiguous=lambda: cotangent)
         if device == "cuda" else cotangent)
    ctx = types.SimpleNamespace(saved_tensors=tuple(saved.values()), inv_keep=1.25,
                                has_b_pos=True)
    out = ia.ImplicitAttention.backward(ctx, g)
    assert out == (*grads[:3], None, *grads[3:], None, None, None)
    assert marks == [("b1_backward_begin", device), ("b1_backward_end", device)]
    ((route, args),) = calls
    if device == "cuda":
        assert route == "kernel"
        assert args[0] is cotangent and args[-1] == P and args[7] == 1.25
        assert args[-2] is saved["rowmax"] and args[-3] is saved["pwr"]
    else:
        assert route == "transcription"
        assert args[0] is cotangent and args[5] is saved["w_pos"] and args[-1] is saved["pwr"]
    ctx.has_b_pos = False
    calls.clear()
    assert ia.ImplicitAttention.backward(ctx, g)[5] is None


def test_backward_launches_count_through_a_replayed_graph(monkeypatch):
    """`backward_launches` is one of the counters a graph capture takes back
    and a replay adds again; the benchmark's sum of B1 and B2 launches reads
    the same keys as before."""
    for name in ("launches", "train_launches", "backward_launches"):
        monkeypatch.setattr(ia.KERNEL, name, 0)
    monkeypatch.setattr(ia.KERNEL, "launches_by_rows", ia.KERNEL.launches_by_rows.copy())
    monkeypatch.setattr(ga.KERNEL, "launches", 0)
    monkeypatch.setattr(ga.KERNEL, "per_head_launches", 0)
    monkeypatch.setattr(ga.KERNEL, "launches_by_rows", ga.KERNEL.launches_by_rows.copy())
    before = graphs.launch_counts()
    assert before[0][0] == {"launches": 0, "train_launches": 0, "backward_launches": 0}
    # what a captured train step adds: two directions, forward and backward
    ia.KERNEL.train_launches += 2
    ia.KERNEL.backward_launches += 2
    ia.KERNEL.launches_by_rows["train", 100] += 2
    delta = graphs._count_delta(graphs.launch_counts(), before)
    graphs._set_counts(before)  # the capture's launches are not counted
    assert ia.KERNEL.backward_launches == 0
    for _ in range(3):  # three replays
        graphs._add_counts(delta)
    counts = graphs.launch_counts()
    assert counts[0][0] == {"launches": 0, "train_launches": 6, "backward_launches": 6}
    assert bench_kernels.launched(counts) == 6


def _global_names(source: str) -> list:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      source)


def test_backward_kernel_names_escape_the_benchmark_matchers():
    """The benchmark finds B1's and B2's launches in a trace by name and holds
    them to the launch counters, and reads B1's roofline from the train
    variant's calls: no kernel of the source but the forward may match."""
    names = _global_names(ia.SOURCE.read_text())
    assert names == ["implicit_attention_kernel", "implicit_attention_bwd_kernel",
                     "implicit_attention_bwd_reduce"]
    for name in names[1:]:
        for shown in (name, f"void (anonymous namespace)::{name}(float const*, int)",
                      f"_ZN12_GLOBAL__N_1{len(name)}{name}EPKfi"):
            assert not bench_kernels.is_b1_train(shown)
            assert not bench_kernels.is_b1_eval(shown)
            assert not bench_kernels.is_b2(shown)
    # the forward's variants as the profiler shows them still match
    assert bench_kernels.is_b1_train("void (anonymous namespace)::implicit_attention_kernel<true>")
    assert bench_kernels.is_b1_eval("void (anonymous namespace)::implicit_attention_kernel<false>")
