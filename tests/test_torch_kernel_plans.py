"""B1's and B2's launch plans, each test over both kernels: the forward's
`tiling_plan` and the backward's `backward_plan` with their shared-memory
functions (the rules they share live in ops/kernels/launch.py), at the
configurations' shapes: R = 100 rows (and 36 and 64, the other roi buckets
of --roi_buckets 36,64,100 and the fixed-36 layout), n = 20 keys, H = 16
heads, dh = o = 64, B1's P = 64 (configs/{butd,spatial,semantic}_vqa.json),
at the batch sizes the port runs (serve 1, 8, 32; eval 64; train 256; the
backward from 8, which --grad_accum and data parallelism divide), and at
the other widths the model's flags give, which run the backward's general
instance; and the refusal of untaken shapes before any build. The kernels
themselves run only on a GPU (chip_smoke.py); these checks need none."""

from __future__ import annotations

import pytest
import torch

from tf_vqa_regat_tpu_torch.ops.kernels import build, launch
from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

MODULES = {"b1": ia, "b2": ga}
# the configurations' widths: (R, n, H, dh, o[, P]) in the plans' order
SHAPES = {"b1": dict(R=100, n=20, H=16, dh=64, o=64, P=64),
          "b2": dict(R=100, n=20, H=16, dh=64, o=64)}
BATCHES = (1, 8, 32, 64, 256)
KERNELS = ("b1", "b2")


def _plan(kernel, b, **over):
    return MODULES[kernel].tiling_plan(b, *{**SHAPES[kernel], **over}.values())


def _bwd_plan(kernel, b, R, H, **over):
    s = {**SHAPES[kernel], **over}
    s.update(R=R, H=H)
    return MODULES[kernel].backward_plan(b, *s.values())


def _no_build(monkeypatch):
    def no_build(*_):
        raise AssertionError("the kernel was built for a shape it does not take")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)


# ---- the forward ----------------------------------------------------------


@pytest.mark.parametrize("R", [1, 7, 8, 9, 36, 64, 100, 101])
@pytest.mark.parametrize("b", BATCHES + (3, 12, 13))
@pytest.mark.parametrize("kernel", KERNELS)
def test_chunks_cover_every_row_once(kernel, b, R):
    plan = _plan(kernel, b, R=R)
    chunks, grid_b = plan.grid
    assert grid_b == b
    covered = [r for c in range(chunks) for r in range(c * plan.rows, min(R, (c + 1) * plan.rows))]
    assert covered == list(range(R))
    assert (chunks - 1) * plan.rows < R  # no empty block


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_shared_memory_fits_a_block(kernel, b):
    """B2's 225,920 B; B1's 228,880 B, which is B2's plus the pos-FC kernel
    in f64 (with 64 bytes between its halves), its bias, the lane
    frequencies and the key-mask row, less K's row padding and B2's
    per-head maxima, which B1 has no use for."""
    plan = _plan(kernel, b)
    assert plan.smem_bytes == {"b1": 228_880, "b2": 225_920}[kernel]
    assert plan.smem_bytes <= launch.SMEM_LIMIT == 232_448
    assert ia.smem_bytes(16, 64, 20, 64, 64) - ga.smem_bytes(16, 64, 20, 64) == 4 * (
        2 * 64 * 16 + 16 + 16 + 64 + 20 - 16 * 20 * 4 - ga.GROUPS * (80 - 8))


@pytest.mark.parametrize("b", BATCHES + (2, 4, 11, 12, 13, 16))
@pytest.mark.parametrize("kernel", KERNELS)
def test_grid_fills_the_card(kernel, b):
    plan = _plan(kernel, b)
    if b * -(-100 // 8) >= launch.SMS:
        assert plan.grid[0] * plan.grid[1] >= launch.SMS
    assert plan.rows >= 8


@pytest.mark.parametrize("kernel", KERNELS)
def test_chunk_sizes_at_the_model_batches(kernel):
    """A whole example per block at b=256, 34 rows at b=64, 20 at b=32, 8-row
    blocks at b <= 8: one rule for both kernels."""
    got = {b: (_plan(kernel, b).rows, _plan(kernel, b).grid) for b in BATCHES}
    assert got == {1: (8, (13, 1)), 8: (8, (13, 8)), 32: (20, (5, 32)), 64: (34, (3, 64)),
                   256: (100, (1, 256))}


@pytest.mark.parametrize("R, want", [
    (36, {1: (8, (5, 1)), 8: (8, (5, 8)), 32: (8, (5, 32)), 64: (12, (3, 64)),
          256: (36, (1, 256))}),
    (64, {1: (8, (8, 1)), 8: (8, (8, 8)), 32: (13, (5, 32)), 64: (22, (3, 64)),
          256: (64, (1, 256))}),
])
@pytest.mark.parametrize("kernel", KERNELS)
def test_chunk_sizes_at_the_bucket_rows(kernel, R, want):
    """The roi buckets 36 and 64 of --roi_buckets 36,64,100, at the serve,
    eval and train batches: whole examples per block at b=256, the card
    filled where the rows allow it."""
    got = {b: (_plan(kernel, b, R=R).rows, _plan(kernel, b, R=R).grid) for b in want}
    assert got == want
    for b, (rows, (chunks, grid_b)) in got.items():
        assert (chunks - 1) * rows < R <= chunks * rows
        if b * -(-R // 8) >= launch.SMS:
            assert chunks * grid_b >= launch.SMS


def _forward_inputs(kernel, b, R, s):
    n, H = s["n"], s["H"]
    qkv = (torch.zeros(b, R, H, s["dh"]), torch.zeros(b, n, H, s["dh"]),
           torch.zeros(b, n, H, s["o"]))
    if kernel == "b2":
        return qkv + (torch.zeros(b, R, 1, n),)
    return qkv + (torch.zeros(b, R, n, 4), torch.zeros(s["P"], H), torch.zeros(H),
                  torch.ones(b, n, dtype=torch.bool), 0.0, None)


# B1: P not a multiple of 8 (nor of 32, the kernel's keep-mask words), dh or
# o not a multiple of 4, n or H over the budget, no keys; B2 the same
# without a pos-FC kernel
UNTAKEN = ([("b1", o) for o in (dict(P=12), dict(P=40), dict(dh=6), dict(o=10), dict(n=40),
                                dict(H=32), dict(H=6), dict(n=0))]
           + [("b2", o) for o in (dict(n=40), dict(H=32), dict(dh=6), dict(o=10), dict(n=0))])


@pytest.mark.parametrize("kernel, over", UNTAKEN)
def test_untaken_shapes_raise_before_any_build(kernel, over, monkeypatch):
    _no_build(monkeypatch)
    with pytest.raises(ValueError):
        _plan(kernel, 2, **over)
    with torch.no_grad(), pytest.raises(ValueError):
        MODULES[kernel].KERNEL(*_forward_inputs(kernel, 2, 3, {**SHAPES[kernel], **over}))


# ---- the backward ---------------------------------------------------------


def _thread_budget_holds(kernel, hb, n, dh, x) -> bool:
    """The dq rows, dK / dVW keys and (head, key) items a thread of a block
    of hb heads keeps fit the kernel's registers and threads (x: B1's P,
    B2's o): B1 has a thread per (head, 4 channels) of a q row in half the
    block and a thread per (head, key) of a row, with P in sets of 16 lanes
    at most one a warp; B2 a thread per (head, 4 channels) of a q row and of
    a g row, each in half the block."""
    m = MODULES[kernel]
    qc, half = hb * dh // 4, m.BWD_THREADS // 2
    rows_d = -(-m.BWD_TILE // (m.BWD_THREADS // qc))
    if kernel == "b1":
        return (rows_d <= m.BWD_MAX_ROWS_D and -(-n // (half // qc)) <= m.BWD_MAX_KEYS
                and hb * n <= m.BWD_THREADS and x % 16 == 0 and x // 16 <= m.BWD_THREADS // 32)
    gc = hb * x // 4
    return (max(qc, gc) <= half and rows_d <= m.BWD_MAX_ROWS_D
            and max(-(-n // (half // qc)), -(-n // (half // gc))) <= m.BWD_MAX_KEYS)


# the shared memory a backward block may take: B1 one block an SM, B2 two
BWD_LIMIT = {"b1": launch.SMEM_LIMIT, "b2": ga.BWD_SMEM_LIMIT}


def _bwd_smem(kernel, hb, s) -> int:
    return MODULES[kernel].bwd_smem_bytes(hb, s["dh"], s["n"], s["P" if kernel == "b1" else "o"])


def _specialised(kernel, hb, s) -> bool:
    return (hb, s["n"], s["dh"], s["P" if kernel == "b1" else "o"]) in \
        MODULES[kernel].BWD_SPECIALISED


@pytest.mark.parametrize("R", [36, 64, 100])
@pytest.mark.parametrize("b", [8, 32, 64, 256])
@pytest.mark.parametrize("kernel, H", [("b1", 4), ("b1", 8), ("b1", 16),
                                       ("b2", 4), ("b2", 8), ("b2", 12), ("b2", 16)])
def test_backward_plan_covers_every_row_once_and_fits(kernel, H, b, R):
    """Every (example, head, row) in exactly one block; the blocks' heads
    divide H; each thread's dq rows and dK / dVW keys and the block's shared
    memory fit; the H that the specialised instance's heads divide run it
    (B1: 16 and 8 heads with 8 a block; B2: every H with 4)."""
    s = SHAPES[kernel]
    plan = _bwd_plan(kernel, b, R, H)
    groups = H // plan.heads
    assert groups * plan.heads == H
    assert plan.grid == (groups * plan.chunks, b)
    assert plan.rows % MODULES[kernel].BWD_TILE == 0
    covered = [r for c in range(plan.chunks)
               for r in range(c * plan.rows, min(R, (c + 1) * plan.rows))]
    assert covered == list(range(R))
    assert (plan.chunks - 1) * plan.rows < R  # no empty block
    assert _thread_budget_holds(kernel, plan.heads, s["n"], s["dh"], s.get("P", s["o"]))
    spec = MODULES[kernel].BWD_SPECIALISED[0]
    assert _specialised(kernel, plan.heads, s) == (H % spec[0] == 0)
    assert plan.smem_bytes == _bwd_smem(kernel, plan.heads, s) <= BWD_LIMIT[kernel]


# (H, over, heads per block) at widths the model's flags give: the
# configuration's; 12 heads; relation_dim 1024 over 8 and 4 heads and 512
# over 16; nongt_dim 36, 50, 12 and 10, and roi buckets of 16 and 7 below
# it (n = R); B1's imp_pos_emb_dim 32, 96 and 128; B2's value width other
# than the head's
FLAG_WIDTHS = (
    [("b1", H, dict(n=n, dh=dh, o=dh, P=P), heads) for H, n, dh, P, heads in (
        (16, 20, 64, 64, 8), (12, 20, 64, 64, 4), (8, 20, 128, 64, 4), (4, 20, 256, 64, 2),
        (16, 20, 32, 64, 8), (8, 36, 64, 64, 4), (4, 50, 64, 64, 2), (8, 12, 128, 32, 4),
        (16, 10, 64, 64, 8), (16, 16, 64, 64, 8), (16, 7, 64, 64, 8), (16, 20, 64, 32, 8),
        (4, 20, 32, 96, 4), (16, 20, 64, 128, 4))]
    + [("b2", H, dict(n=n, dh=dh, o=o), heads) for H, n, dh, o, heads in (
        (16, 20, 64, 64, 4), (12, 20, 64, 64, 4), (8, 20, 128, 128, 2), (4, 20, 256, 256, 1),
        (16, 20, 32, 32, 8), (8, 36, 64, 64, 2), (4, 50, 64, 64, 1), (16, 10, 64, 64, 4),
        (8, 12, 128, 128, 2), (16, 16, 64, 64, 4), (16, 7, 64, 64, 4), (16, 20, 64, 32, 4),
        (4, 20, 32, 96, 2))])


@pytest.mark.parametrize("kernel, H, over, heads", FLAG_WIDTHS)
def test_backward_blocks_fit_registers_and_shared_memory(kernel, H, over, heads):
    """At each width: the plan's heads a block, whose dq rows, dK / dVW keys
    and (head, key) items a thread keeps fit the kernel's registers and
    threads, and whose layout fits a block's shared memory (B2: two blocks
    an SM); the configurations' widths alone run the specialised
    instance."""
    m, s = MODULES[kernel], {**SHAPES[kernel], **over}
    plan = _bwd_plan(kernel, 256, 100, H, **over)
    hb = plan.heads
    assert hb == heads and H % hb == 0 and hb <= 8
    assert _thread_budget_holds(kernel, hb, s["n"], s["dh"], s.get("P", s["o"]))
    assert plan.smem_bytes == _bwd_smem(kernel, hb, s) <= BWD_LIMIT[kernel]
    assert getattr(m, "BWD_BLOCKS_PER_SM", 1) * (plan.smem_bytes + 1024) <= 233_472
    spec = m.BWD_SPECIALISED[0]
    widths = (s["n"], s["dh"], s["P" if kernel == "b1" else "o"])
    assert _specialised(kernel, hb, s) == (widths == spec[1:] and H % spec[0] == 0)


# ((b, R, H), over, (heads, rows, chunks, grid, shared memory)): butd's and
# spatial's b=256 step (B1: 8 heads and two blocks an example; B2: 4 heads
# and four blocks an example, two an SM) with the whole example per block;
# smaller batches cut the rows so that the card fills; the roi buckets; 12,
# 8 and 4 heads; dh = 128 at relation_dim 1024 over 8 heads
MODEL_SHAPES = {
    "b1": [((256, 100, 16), {}, (8, 104, 1, (2, 256), 213_904)),
           ((64, 100, 16), {}, (8, 104, 1, (2, 64), 213_904)),
           ((32, 100, 16), {}, (8, 56, 2, (4, 32), 213_904)),
           ((8, 100, 16), {}, (8, 16, 7, (14, 8), 213_904)),
           ((256, 100, 4), {}, (4, 104, 1, (1, 256), 119_952)),
           ((256, 100, 12), {}, (4, 104, 1, (3, 256), 119_952)),
           ((256, 100, 8), dict(dh=128, o=128), (4, 104, 1, (2, 256), 193_680))],
    "b2": [((256, 100, 16), {}, (4, 104, 1, (4, 256), 88_640)),
           ((64, 100, 16), {}, (4, 104, 1, (4, 64), 88_640)),
           ((32, 100, 16), {}, (4, 56, 2, (8, 32), 88_640)),
           ((8, 100, 16), {}, (4, 16, 7, (28, 8), 88_640)),
           ((256, 64, 16), {}, (4, 64, 1, (4, 256), 88_640)),
           ((256, 36, 16), {}, (4, 40, 1, (4, 256), 88_640)),
           ((256, 100, 8), {}, (4, 104, 1, (2, 256), 88_640)),
           ((256, 100, 12), {}, (4, 104, 1, (3, 256), 88_640)),
           ((256, 100, 8), dict(dh=128, o=128), (2, 104, 1, (4, 256), 81_216))],
}


@pytest.mark.parametrize("kernel", KERNELS)
def test_backward_plan_at_the_model_shapes(kernel):
    for (b, R, H), over, want in MODEL_SHAPES[kernel]:
        assert tuple(_bwd_plan(kernel, b, R, H, **over)) == want


def _backward_inputs(kernel, b, R, H, s):
    n = s["n"]
    g, q = torch.zeros(b, R, H, s["o"]), torch.zeros(b, R, H, s["dh"])
    k, vw = torch.zeros(b, n, H, s["dh"]), torch.zeros(b, n, H, s["o"])
    if kernel == "b2":
        return g, q, k, vw, torch.zeros(b, R, 1, n), torch.zeros(b, R)
    return (g, q, k, vw, torch.zeros(b, R, n, 4), torch.zeros(b, n), None, 1.0,
            torch.zeros(b, R, H, n), torch.zeros(b, R), s["P"])


# B1: dh != o, dh not a multiple of 4, P not a multiple of 16 or over 256,
# more keys than the threads' registers hold, a head wider than the dq
# threads, no keys; B2: dh or o not a multiple of 4, the same key and head
# budgets, no keys
UNTAKEN_BWD = (
    [("b1", o) for o in (dict(o=32), dict(dh=6, o=6), dict(P=8), dict(P=272), dict(P=40),
                         dict(n=200), dict(dh=1024, o=1024), dict(n=0))]
    + [("b2", o) for o in (dict(dh=6, o=6), dict(o=10), dict(n=400), dict(dh=2048, o=2048),
                           dict(n=0))])


@pytest.mark.parametrize("kernel, over", UNTAKEN_BWD)
def test_untaken_backward_shapes_raise_before_any_build(kernel, over, monkeypatch):
    _no_build(monkeypatch)
    with pytest.raises(ValueError):
        _bwd_plan(kernel, 2, 3, 4, **over)
    with pytest.raises(ValueError):
        MODULES[kernel]._Kernel().backward(
            *_backward_inputs(kernel, 2, 3, 4, {**SHAPES[kernel], **over}))
