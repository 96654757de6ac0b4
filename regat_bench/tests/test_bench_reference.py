"""The plain reference against the program's CPU path at small widths (the
test, not the reference, imports both), its control in TF32 and its
planted faults, which the comparison must catch; and the reference's
imports."""

import ast
import os
import subprocess
import sys

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


@pytest.mark.parametrize("fault", ["half", "unchanged"])
def test_faults_fail(captured, fault):
    drv, ctx, cap, raw, n, ref32 = captured
    got = drv.numbers(drv.reference_outputs(ctx, raw, cap, n, "f32", fault), ref32)
    limits = manifest.limits(ctx.workload["name"])
    assert any(got[k] > limits[k] for k in limits), got


def test_reference_imports_only_torch_numpy_and_stdlib():
    allowed = {"torch", "numpy", "math", "contextlib", "typing", "__future__"}
    for name in os.listdir(REF):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(REF, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] in allowed, (name, m)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import regat_bench.reference.regat, regat_bench.reference.data, "
            "regat_bench.reference.params; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'tf_vqa_regat_tpu_torch', 'tf_vqa_regat_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, check=True)
    assert out.stdout.strip() == "[]"
