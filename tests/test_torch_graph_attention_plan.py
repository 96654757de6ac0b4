"""The B2 wrapper's tiling plan (`tiling_plan`), which sizes the CUDA
kernel's launch, at the configs' shapes: R = 100 rows (and 36 and 64, the
other roi buckets of --roi_buckets 36,64,100 and the fixed-36 layout), n =
20 keys, H = 16 heads, dh = o = 64 (configs/{spatial,semantic}_vqa.json), at
the batch sizes the port runs (serve 1, 8, 32; eval 64; train 256). The kernel itself runs only on a
GPU (chip_smoke.py); these checks need none."""

from __future__ import annotations

import pytest
import torch

from tf_vqa_regat_tpu_torch.ops.kernels import build
from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

SHAPE = dict(R=100, n=20, H=16, dh=64, o=64)
BATCHES = (1, 8, 32, 256)


def _plan(b, **over):
    s = {**SHAPE, **over}
    return ga.tiling_plan(b, s["R"], s["n"], s["H"], s["dh"], s["o"])


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
    assert _plan(b).smem_bytes <= 232_448


@pytest.mark.parametrize("b", BATCHES + (2, 4, 11, 12, 13, 16, 64))
def test_grid_fills_the_card(b):
    plan = _plan(b)
    if b * -(-SHAPE["R"] // 8) >= ga.SMS:
        assert plan.grid[0] * plan.grid[1] >= ga.SMS
    assert plan.rows >= min(8, SHAPE["R"])


def test_chunk_sizes_at_the_model_batches():
    """A whole example per block at b=256, 20 rows at b=32, 8-row blocks at
    b <= 8."""
    got = {b: (_plan(b).rows, _plan(b).grid) for b in BATCHES}
    assert got == {1: (8, (13, 1)), 8: (8, (13, 8)), 32: (20, (5, 32)), 256: (100, (1, 256))}


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


@pytest.mark.parametrize("over", [dict(n=40), dict(H=32), dict(dh=6), dict(o=10), dict(n=0)])
def test_untaken_shapes_raise_before_any_build(over, monkeypatch):
    def no_build(*_):
        raise AssertionError("the kernel was built for a shape it does not take")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    with pytest.raises(ValueError):
        _plan(2, **over)
    s = {**SHAPE, **over}
    q = torch.zeros(2, 3, s["H"], s["dh"])
    k = torch.zeros(2, s["n"], s["H"], s["dh"])
    vw = torch.zeros(2, s["n"], s["H"], s["o"])
    with torch.no_grad(), pytest.raises(ValueError):
        ga.KERNEL(q, k, vw, torch.zeros(2, 3, 1, s["n"]))
