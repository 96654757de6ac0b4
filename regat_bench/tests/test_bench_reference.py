"""The plain reference against the program's CPU path at small widths (the
test, not the reference, imports both), its control in TF32 and its
planted faults, which the comparison must catch; and the reference's
imports."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from regat_bench import manifest
from regat_bench.tests import small

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REF = os.path.join(ROOT, "regat_bench", "reference")
# the program's CPU path runs the plain pos-FC in f32, the reference sums it
# in f64 (reference/regat.py): the pos-FC bias' gradient parts by ~1e-4 here
PROGRAM_ON_CPU = {"step_loss": 1e-6, "grad": 1e-3, "change": 1e-5}


@pytest.fixture(scope="module", params=["butd.train", "spatial.train"])
def captured(request):
    ctx, _ = small.context(request.param)
    drv = manifest.driver(ctx.mix["driver"])
    cell = drv.Cell(ctx)
    cap = cell.capture()
    raw, n = (cell.raw_train, cell.raw_val), cell.steps_per_epoch
    cell.free()
    return drv, ctx, cap, raw, n, drv.reference_outputs(ctx, raw, cap, n)


def test_program_matches_reference(captured):
    drv, ctx, cap, raw, n, ref32 = captured
    got = drv.numbers(cap, ref32)
    for k, limit in PROGRAM_ON_CPU.items():
        assert got[k] <= limit, (k, got)


def test_tf32_control_fails(captured):
    drv, ctx, cap, raw, n, ref32 = captured
    got = drv.numbers(drv.reference_outputs(ctx, raw, cap, n, "tf32"), ref32)
    program = drv.numbers(cap, ref32)
    assert got["grad"] > 10 * program["grad"] and got["change"] > 10 * program["change"], got


def test_first_step_is_held_to_the_nearest_neighbour(captured):
    """A reference whose first gradient sits across a kink (every leaf moved
    by 1e-4 of itself) reads far from the program; a nudged copy of it on
    the program's side of the kink brings the first step's numbers back."""
    drv, ctx, cap, raw, n, ref32 = captured
    assert len(drv.reference_outputs(ctx, raw, cap, n, neighbours=2)["first"]) == 2
    across = dict(ref32, grad={k: v * (1 + 1e-4) for k, v in ref32["grad"].items()},
                  first=[])
    far = drv.numbers(cap, across)
    near = drv.numbers(cap, dict(across, first=[{"grad": ref32["grad"],
                                                 "change1": ref32["change1"]}]))
    assert far["grad_median"] > 5e-5 and far["grad_median_exact"] == far["grad_median"]
    assert near["grad_median"] == drv.numbers(cap, ref32)["grad_median"] < 1e-5
    assert near["grad_median_exact"] == far["grad_median"]


@pytest.mark.parametrize("fault", ["half", "unchanged"])
def test_faults_fail(captured, fault):
    drv, ctx, cap, raw, n, ref32 = captured
    got = drv.numbers(drv.reference_outputs(ctx, raw, cap, n, "f32", fault), ref32)
    limits = manifest.limits(ctx.workload["name"])
    assert any(got[k] > limits[k] for k in limits), got


def test_exchange_fault_fails_where_a_step_has_ranks(captured):
    """The captured steps cut in two ranks' rows: the reference with rank
    0's rows alone (the all-reduce left out) in the program's place."""
    drv, ctx, cap, raw, n, ref32 = captured
    two = dict(cap, steps=[(R, np.array_split(np.concatenate(parts), 2))
                           for R, parts in cap["steps"]])
    got = drv.numbers(drv.reference_outputs(ctx, raw, two, n, "f32", "exchange"), ref32)
    assert got["train_n"] > manifest.limits(ctx.workload["name"])["train_n"], got


def test_reference_imports_only_torch_numpy_and_stdlib():
    """Its own modules aside (relative imports, fusion files included)."""
    allowed = {"torch", "numpy", "math", "contextlib", "typing", "__future__", "importlib",
               "os", "types"}
    files = [os.path.join(d, f) for d, _, fs in os.walk(REF) for f in fs if f.endswith(".py")]
    assert os.path.join(REF, "fusion", "butd.py") in files
    for name in files:
        tree = ast.parse(open(name).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [] if node.level else [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, (name, m)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import regat_bench.reference.regat, regat_bench.reference.data, "
            "regat_bench.reference.params, regat_bench.reference.fusion.butd; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tf_vqa_regat_tpu_torch', 'tf_vqa_regat_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True)
    assert out.stdout.strip() == "[]"
