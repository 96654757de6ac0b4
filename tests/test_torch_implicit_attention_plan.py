"""The B1 wrapper's tiling plan (`tiling_plan`) and shared-memory function,
which size the CUDA kernel's launch, at the implicit config's shapes: R = 100
rows (and 36 and 64, the other roi buckets of --roi_buckets 36,64,100 and the
fixed-36 layout), n = 20 keys, H = 16 heads, dh = o = 64, P = 64
(configs/butd_vqa.json), at the batch sizes the port runs (serve 1, 8, 32;
eval 64; train 256). The
kernel itself runs only on a GPU (chip_smoke.py); these checks need none."""

from __future__ import annotations

import types

import pytest
import torch

from tf_vqa_regat_tpu_torch.ops.kernels import build
from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

SHAPE = dict(R=100, n=20, H=16, dh=64, o=64, P=64)
BATCHES = (1, 8, 32, 64, 256)


def _plan(b, **over):
    s = {**SHAPE, **over}
    return ia.tiling_plan(b, s["R"], s["n"], s["H"], s["dh"], s["o"], s["P"])


@pytest.mark.parametrize("R", [1, 7, 8, 9, 36, 64, 100, 101])
@pytest.mark.parametrize("b", BATCHES + (3, 12, 13))
def test_chunks_cover_every_row_once(b, R):
    plan = _plan(b, R=R)
    chunks, grid_b = plan.grid
    assert grid_b == b
    covered = [r for c in range(chunks) for r in range(c * plan.rows, min(R, (c + 1) * plan.rows))]
    assert covered == list(range(R))
    assert (chunks - 1) * plan.rows < R  # no empty block


@pytest.mark.parametrize("b", BATCHES)
def test_shared_memory_fits_a_block(b):
    """B2's 225,920 B plus the pos-FC kernel in f64 (with 64 bytes between
    its halves), its bias, the lane frequencies and the key-mask row, less
    K's row padding and B2's per-head maxima, which B1 has no use for."""
    plan = _plan(b)
    assert plan.smem_bytes == 228_880 <= ga.SMEM_LIMIT == 232_448
    assert plan.smem_bytes - ga.smem_bytes(16, 64, 20, 64) == 4 * (
        2 * 64 * 16 + 16 + 16 + 64 + 20 - 16 * 20 * 4 - ga.GROUPS * (80 - 8))


@pytest.mark.parametrize("b", BATCHES + (2, 4, 11, 12, 13, 16))
def test_grid_fills_the_card(b):
    plan = _plan(b)
    if b * -(-SHAPE["R"] // 8) >= ga.SMS:
        assert plan.grid[0] * plan.grid[1] >= ga.SMS
    assert plan.rows >= min(8, SHAPE["R"])


def test_chunk_sizes_at_the_model_batches():
    """A whole example per block at b=256, 34 rows at b=64, 20 at b=32, 8-row
    blocks at b <= 8: B2's rule, shared."""
    got = {b: (_plan(b).rows, _plan(b).grid) for b in BATCHES}
    assert got == {1: (8, (13, 1)), 8: (8, (13, 8)), 32: (20, (5, 32)), 64: (34, (3, 64)),
                   256: (100, (1, 256))}
    for b in BATCHES:
        assert _plan(b).rows == ga.tiling_plan(b, 100, 20, 16, 64, 64).rows


@pytest.mark.parametrize("R, want", [
    (36, {1: (8, (5, 1)), 8: (8, (5, 8)), 32: (8, (5, 32)), 64: (12, (3, 64)),
          256: (36, (1, 256))}),
    (64, {1: (8, (8, 1)), 8: (8, (8, 8)), 32: (13, (5, 32)), 64: (22, (3, 64)),
          256: (64, (1, 256))}),
])
def test_chunk_sizes_at_the_bucket_rows(R, want):
    """The roi buckets 36 and 64 of --roi_buckets 36,64,100, at the serve,
    eval and train batches: whole examples per block at b=256, the card
    filled where the rows allow it."""
    got = {b: (_plan(b, R=R).rows, _plan(b, R=R).grid) for b in want}
    assert got == want
    for b, (rows, (chunks, grid_b)) in got.items():
        assert (chunks - 1) * rows < R <= chunks * rows
        if b * -(-R // 8) >= ga.SMS:
            assert chunks * grid_b >= ga.SMS


@pytest.mark.parametrize("over", [dict(P=12), dict(P=40), dict(dh=6), dict(o=10), dict(n=40),
                                  dict(H=32), dict(H=6), dict(n=0)])
def test_untaken_shapes_raise_before_any_build(over, monkeypatch):
    """P not a multiple of 8 (nor of 32, the kernel's keep-mask words), dh or
    o not a multiple of 4, n or H over the budget, no keys."""

    def no_build(*_):
        raise AssertionError("the kernel was built for a shape it does not take")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    with pytest.raises(ValueError):
        _plan(2, **over)
    s = {**SHAPE, **over}
    b, R, n, H, P = 2, 3, s["n"], s["H"], s["P"]
    args = (torch.zeros(b, R, H, s["dh"]), torch.zeros(b, n, H, s["dh"]),
            torch.zeros(b, n, H, s["o"]), torch.zeros(b, R, n, 4), torch.zeros(P, H),
            torch.zeros(H), torch.ones(b, n, dtype=torch.bool))
    with torch.no_grad(), pytest.raises(ValueError):
        ia.KERNEL(*args, 0.0, None)


def test_a_sliced_key_mask_is_read_through_its_row_stride(monkeypatch):
    """The model passes roi_mask[:, :n], a slice of a wider mask: the launch
    takes its row stride and copies nothing; a mask whose keys are not
    contiguous is refused before any build."""

    def built(*_):
        raise RuntimeError("built")

    monkeypatch.setattr(build, "build", built)
    monkeypatch.setattr(build, "load", built)
    b, R, n, H, P = 2, 3, 20, 16, 64
    args = (torch.zeros(b, R, H, 64), torch.zeros(b, n, H, 64), torch.zeros(b, n, H, 64),
            torch.zeros(b, R, n, 4), torch.zeros(P, H), torch.zeros(H))
    wide = torch.ones(b, 100, dtype=torch.bool)
    kernel = ia._Kernel()
    with torch.no_grad(), pytest.raises(RuntimeError, match="built"):
        kernel(*args, wide[:, :n], 0.0, None)
    assert [a.sm for a in kernel._launch_args.values()] == [100]
    with torch.no_grad(), pytest.raises(ValueError, match="keys must be contiguous"):
        kernel(*args, wide[:, ::5], 0.0, None)


def test_the_plan_is_held_to_the_kernel_layout_at_load(monkeypatch):
    """`_Kernel.lib()` refuses a library whose shared-memory layout is not
    the plan's: a kernel edited without its plan never launches."""

    def fake_lib(extra):
        return types.SimpleNamespace(
            regat_implicit_attention_fwd=_Function(None),
            regat_implicit_attention_set_smem=_Function(None),
            regat_implicit_attention_smem_bytes=_Function(lambda *s: ia.smem_bytes(*s) + extra),
        )

    for extra in (0, 16):
        monkeypatch.setattr(build, "load", lambda _source, e=extra: fake_lib(e))
        kernel = ia._Kernel()
        if extra == 0:
            assert kernel.lib() is not None
        else:
            with pytest.raises(RuntimeError, match="disagree on shared memory"):
                kernel.lib()


class _Function:
    """A stand-in for a ctypes function: callable, with settable argtypes."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)
