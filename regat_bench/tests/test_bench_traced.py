"""The traced epoch's step count when a traced epoch is dropped, and the
readers of the data-parallel cell's collectives on a synthetic trace."""

import time
import types

import pytest
import torch

from regat_bench import manifest, tracing
from regat_bench.drivers import train_epoch
from regat_bench.tests import small


def test_a_dropped_traced_epoch_leaves_the_traced_step_count(monkeypatch):
    """The first traced epoch is dropped (lost records, faked), the second
    kept; then the window's clock runs out: the count is the second's."""
    ctx, _ = small.context("butd.train", trace=1)
    cell = train_epoch.Cell(ctx)
    cell.capture()
    calls, offset = [], [0.0]

    def lost(device, trace, launched_before):
        calls.append(trace)
        if len(calls) == 2:
            offset[0] = 1e6  # the window's time is up after the kept epoch
        return len(calls) == 1

    monkeypatch.setattr(train_epoch, "lost_records", lost)
    monkeypatch.setattr(train_epoch, "time", types.SimpleNamespace(
        perf_counter=lambda: time.perf_counter() + offset[0]))
    c, trace = train_epoch._window(cell, 1000.0, 0.0)
    cell.free()
    assert len(calls) == 2 and trace is calls[1]
    assert c["traces_dropped"] == 1
    assert c["train_steps"] == 2 * cell.steps_per_epoch
    assert c["traced_train_steps"] == cell.steps_per_epoch


M = "regat_mark_"


def _step(t, nccl=True):
    """One data-parallel step's marks and kernels from t (ns): the reduce
    phase holds the write of the sums [t+40, t+44) and the all-reduce
    [t+44, t+54)."""
    ops = [(M + "gather", t, t + 2), ("gather_kernel", t + 2, t + 6),
           (M + "forward", t + 6, t + 8), ("gemm", t + 8, t + 20),
           (M + "backward", t + 20, t + 22), ("gemm", t + 22, t + 36),
           (M + "reduce", t + 38, t + 40), ("copy_kernel", t + 40, t + 44),
           (M + "optimizer", t + 60, t + 62), ("adamax", t + 62, t + 70), (M + "end", t + 70, t + 72)]
    if nccl:
        ops.append(("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
                    t + 44, t + 54))
    return ops


def _record(ops, steps=2):
    trace = tracing.Trace(torch.device("cpu"))
    trace.spans = [("train_pass", 0, 300), ("eval_pass", 300, 400)]
    trace.device_ops = list(ops) + [("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 310, 330)]
    return tracing.Record({"name": "butd.train.dp4"}, {}, {}, 4,
                          counters={"traced_train_steps": steps}, trace=trace)


@pytest.mark.parametrize("metric,want", [("reduce_ms.dp4", (4 + 10) / 1e6),
                                         ("allreduce_ms.dp4", 10 / 1e6)])
def test_collective_readers_on_a_synthetic_trace(metric, want):
    read = manifest.reader(metric).read
    assert read(_record(_step(100) + _step(0))) == pytest.approx(want, rel=1e-12)
    assert read(tracing.Record({}, {}, {}, 4)) is None


def test_collective_readers_without_a_process_group():
    """A one-card step marks no reduce and launches no NCCL kernel."""
    ops = [op for op in _step(0, nccl=False) + _step(100, nccl=False) if op[0] != M + "reduce"]
    rec = _record(ops)
    rec.trace.device_ops = [op for op in rec.trace.device_ops if "nccl" not in op[0]]
    assert manifest.reader("reduce_ms.dp4").read(rec) is None
    assert manifest.reader("allreduce_ms.dp4").read(rec) is None
