"""On a CUDA card (marker `card`; skipped elsewhere): the controls at a size
a test run holds. The reference computed with TF32 matmuls, put in the
program's place, has to fail the comparison that the program passes; run
on the card by `pytest regat_bench/ -m card`."""

import pytest
import torch

from regat_bench import manifest
from regat_bench.tests import small


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 matmuls and the program's kernels run there only")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["butd.train", "spatial.train"])
def test_tf32_control_fails_on_the_card(workload):
    device = _card()
    ctx, _ = small.context(workload)
    ctx.device = device
    drv = manifest.driver(ctx.mix["driver"])
    for seed in (1, 2, 3):
        ctx.seed = seed
        got = drv.readings(ctx, [])
        # the cell's limits hold at its full size; here the control has to
        # read well above the program
        assert got["control"]["grad"] > 10 * got["program"]["grad"], got


@pytest.mark.card
def test_tf32_control_fails_the_served_answers_on_the_card():
    device = _card()
    ctx, _ = small.context("butd.serve")
    ctx.device = device
    drv = manifest.driver(ctx.mix["driver"])
    limits = manifest.limits("butd.serve")
    got = drv.readings(ctx, ["answer"])
    assert any(got["control"][k] > limits[k] for k in limits), got
    assert any(got["answer"][k] > limits[k] for k in limits), got
