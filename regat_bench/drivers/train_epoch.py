"""Training epochs, as the program's run_training runs them: a train pass over
the train split in blocks (`_DataPath.train_stream`, `TrainSteps.block` on
the device store, graphs replayed), then an eval pass over val
(`EvalSteps.block` on `blocked_eval_stream`), the two step runners sharing
one graph pool, repeated until the window ends.

Set-up builds the inputs and weights from the seed, the program's store,
model, optimizer and both step runners; then, through the window's own
calls and graphs, one eval pass at the initial weights, the first optimizer
step alone (a block of one, so that the first gradient can be read from the
optimizer's state) and epoch 0's second block as the window runs it (its
block size: 8 steps at --train_block auto), whose outputs the reference
checks after the window. The window starts at epoch 1 with the optimizer
at step 9. Every pass is timed whole on the host clock and ends on a
synchronise (its metrics are read), so each second of the window belongs
to a train or an eval pass.

The mix's keys: "program" (the program's settings: eval batch, blocks, data
mode) and "trace_after" (the share of the window after which the traced run
profiles one epoch).
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from regat_bench import compare, flops, inputs, kernels, port, tracing
from regat_bench.reference import data as refdata
from regat_bench.reference import regat as ref
from regat_bench.weights import make_weights
from tf_vqa_regat_tpu_torch.parallel import distributed
from tf_vqa_regat_tpu_torch.parallel.mesh import Mesh, make_mesh
from tf_vqa_regat_tpu_torch.train import graphs
from tf_vqa_regat_tpu_torch.train.loop import _DataPath
from tf_vqa_regat_tpu_torch.train.step import TrainSteps

VAL_SEED = 1_000_003  # the val split's seed is the run's plus this


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    """The program's side of a run, built from the seed."""

    def __init__(self, ctx):
        cfg, mix, seed, device = ctx.cfg, ctx.mix, ctx.seed, ctx.device
        self.device = device
        self.raw_train = inputs.make_split(cfg, seed, cfg["train_questions"],
                                           cfg["train_images"], device)
        self.raw_val = inputs.make_split(cfg, seed + VAL_SEED, cfg["val_questions"],
                                         cfg["val_images"], device)
        self.weights = make_weights(cfg, seed, device)
        dp = distributed.world_size()
        self.pcfg = port.config(cfg, seed, dp_size=dp, **mix["program"])
        mesh = make_mesh(dp) if dp > 1 else Mesh(dp=1)
        rt = cfg["relation_type"]
        train_ds = port.dataset(self.raw_train, "train", rt)
        val_ds = port.dataset(self.raw_val, "val", rt)
        self.model = port.model(self.pcfg, train_ds, self.weights, device)
        self.lines = port.Lines()
        self.data = _DataPath(self.pcfg, train_ds, val_ds, device, self.lines, mesh)
        self.steps_per_epoch = self.data.steps_per_epoch
        self.opt = port.adamax(self.model, self.pcfg, self.steps_per_epoch)
        self.train = TrainSteps(self.model, self.opt, self.pcfg, device, self.data.train_store,
                                mesh=self.data.mesh)
        self.evaluate = self.data.eval_steps_of(self.model, pool=self.train.graphs.pool)

    def entries(self, store, idx: np.ndarray) -> np.ndarray:
        """The split's entry indices (-1 kept) of a global index batch or
        block: a sharded store's segments hold its shards' local ids."""
        return store.to_global(idx) if hasattr(store, "to_global") else idx

    def capture(self) -> Dict[str, Any]:
        """What the reference checks, each call as the window makes it: one
        eval pass at the initial weights (per block its loss sum, score and
        count), then the first step of epoch 0 as a block of one (its loss
        sum and count, and the first gradient as the optimizer got it), then
        epoch 0's second block at the window's block size (its loss sum and
        count over all its steps), and the change of the parameters after
        them; each step's entries by data-parallel rank. These calls also
        warm up and capture every graph the window replays."""
        out: Dict[str, Any] = {"eval_blocks": [], "eval": [], "steps": [], "calls": []}
        for R, blk in self.data.eval_stream():
            m = self.evaluate.block(R, blk)
            out["eval_blocks"].append((R, self.entries(self.data.eval_store, blk)))
            out["eval"].append(sums(m))
        names = self.opt.names
        stream = iter(self.data.train_stream(0))
        _, (R, first) = next(stream)
        nsteps, (R2, second) = next(stream, (0, (None, None)))
        if nsteps < 2:
            raise ValueError("the check needs epoch 0 to have a second block of "
                             "two steps or more")
        w0 = [p.detach().clone() for p in self.opt.params]
        for R, blk, n in ((R, first[:1], 1), (R2, second, nsteps)):
            m = self.train.block(R, blk, n)
            for row in blk[:n]:
                ids = self.entries(self.data.train_store, row)
                out["steps"].append((R, np.split(ids, self.data.mesh.dp)))
            out["calls"].append((n, float(m["loss_sum"]), float(m["n"])))
            if "grad" not in out:
                out["grad"] = compare.norms({k: mu / (1.0 - self.opt.b1)
                                             for k, mu in zip(names, self.opt.mu)})
                out["change1"] = compare.norms({k: p.detach() - p0 for k, p, p0
                                                in zip(names, self.opt.params, w0)})
        out["change"] = compare.norms({k: p.detach() - p0 for k, p, p0
                                       in zip(names, self.opt.params, w0)})
        sync(self.device)
        return out

    def free(self) -> None:
        for k in ("train", "evaluate", "data", "model", "opt"):
            setattr(self, k, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sums(m: Dict[str, torch.Tensor]) -> tuple:
    """An eval block's (loss sum, score, count) on the host."""
    return float(m["loss"] * m["n"]), float(m["score"]), float(m["n"])


def lost_records(device: torch.device, trace, launched_before: int) -> bool:
    """Whether the profiler recorded fewer calls of B1 and B2 in the traced
    passes than the program launched since `launched_before`: the trace
    lost device records."""
    return (device.type == "cuda" and kernels.recorded(trace, ("train_pass", "eval_pass"))
            != kernels.launched(graphs.launch_counts()) - launched_before)


def _window(cell: Cell, seconds: float, trace_after: Optional[float]):
    """Epochs from epoch 1 until `seconds` have passed -> (counters, trace or
    None); with `trace_after`, the first epoch that starts past that share
    of the window is profiled. A traced epoch that lost device records
    (`lost_records`) is dropped, its steps with it, and the next epoch is
    traced instead; "traced_train_steps" counts the kept one's."""
    c = {"train_questions": 0.0, "train_seconds": 0.0, "eval_questions": 0.0,
         "eval_seconds": 0.0, "train_steps": 0, "eval_batches": 0, "passes": 0,
         "traced_train_steps": 0, "traces_dropped": 0}
    device, data, train, evaluate = cell.device, cell.data, cell.train, cell.evaluate
    trace = None
    before = graphs.launch_counts()
    t_start = time.perf_counter()
    epoch = 1

    def left() -> bool:  # every rank stops at the same block
        return not distributed.any_rank(time.perf_counter() - t_start >= seconds)

    while left():
        traced = (trace_after is not None and trace is None and distributed.any_rank(
            time.perf_counter() - t_start >= trace_after * seconds))
        if traced:
            trace = tracing.Trace(device)
            traced_from = kernels.launched(graphs.launch_counts())
            trace.start()
        t = time.perf_counter()
        acc = torch.zeros(3, device=device)  # loss_sum, score, n
        steps = 0
        with tracing.span("train_pass"):
            for nsteps, (R, blk) in data.train_stream(epoch):
                with tracing.span("train_block"):
                    m = train.block(R, blk, nsteps)
                    acc += torch.stack([m["loss_sum"], m["score"], m["n"]])
                steps += nsteps
                if not left():
                    break
            n = float(acc[2])  # the pass ends on its metrics on the host
        dt = time.perf_counter() - t
        if not traced:
            c["train_questions"] += n
            c["train_seconds"] += dt
        c["train_steps"] += steps
        if not left() and not traced:
            break
        t = time.perf_counter()
        acc = torch.zeros(3, device=device)
        with tracing.span("eval_pass"):
            for R, blk in data.eval_stream():
                with tracing.span("eval_block"):
                    m = evaluate.block(R, blk)
                    acc += torch.stack([m["loss"] * m["n"], m["score"], m["n"]])
                c["eval_batches"] += int((blk >= 0).any(axis=1).sum())
                if not left() and not traced:
                    break
            n = float(acc[2])
        dt = time.perf_counter() - t
        if traced:
            trace.stop()
            trace.read()
            if distributed.any_rank(lost_records(device, trace, traced_from)):
                c["traces_dropped"] += 1
                trace = None
            else:
                c["traced_train_steps"] = steps
        else:
            c["eval_questions"] += n
            c["eval_seconds"] += dt
        c["passes"] += 1
        epoch += 1
    (b1, _), (b2, _) = graphs.launch_counts()
    (b1_0, _), (b2_0, _) = before
    c["b1_train_launches"] = b1["train_launches"] - b1_0["train_launches"]
    c["b1_eval_launches"] = b1["launches"] - b1_0["launches"]
    c["b2_launches"] = b2["launches"] - b2_0["launches"]
    return c, trace


# the reference's first step is also taken from this many copies of the
# initial weights, each nudged by one unit in the last place (`numbers`)
NEIGHBOURS = 4


def nudged(w: Dict[str, torch.Tensor], seed: int, device) -> Dict[str, torch.Tensor]:
    """`w` with every element moved by one unit in the last place, up or down
    as drawn from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {k: torch.nextafter(v, torch.where(
        torch.rand(v.shape, generator=gen, device=device) < 0.5, -torch.inf, torch.inf))
        for k, v in w.items()}


def reference_outputs(ctx, cell_raw, captured: Dict[str, Any], steps_per_epoch: int,
                      precision: str = "f32", fault: str = "",
                      neighbours: int = 0) -> Dict[str, Any]:
    """What the reference computes for the captured calls, from the seed's
    inputs and weights, in the captured form: per eval block its (loss sum,
    score, count), per train call its (steps, loss sum, count), the first
    gradient's and the change's leaf norms. `fault` plants one of the faults
    the comparison must catch, in the reference put in the program's place:
    "half" (each step and each eval batch runs the first half of its batch,
    the mean taken over it), "unchanged" (the steps leave the parameters as
    they are), "replay" (each train call runs its first batch at every
    step), "exchange" (each step runs data-parallel rank 0's rows alone, as
    rank 0 does with the all-reduce of the gradient sums left out); and
    "ulp", no fault but a witness: the initial weights moved by one unit in
    the last place, in a direction drawn from the seed. With `neighbours`,
    "first" lists the first gradient's and change's leaf norms of the first
    step taken again from that many nudged copies of the initial weights
    (directions drawn from seed + 1, seed + 2, ...)."""
    raw_train, raw_val = cell_raw
    cfg, device, seed = ctx.cfg, ctx.device, ctx.seed
    w0 = make_weights(cfg, seed, device)
    if fault == "ulp":
        w0 = nudged(w0, seed, device)
    nx = ref.Numerics(precision)
    out: Dict[str, Any] = {"eval": [], "calls": [], "first": []}

    def kept(ids: np.ndarray) -> np.ndarray:
        ids = ids[ids >= 0]
        return ids[: len(ids) // 2] if fault == "half" else ids

    with nx.active(device):
        for R, blk in captured["eval_blocks"]:
            total, score, count = 0.0, 0.0, 0
            for row in blk:
                ids = kept(row)
                if len(ids) == 0:
                    continue
                batch = refdata.make_batch(raw_val, ids, R, device)
                _, loss, s = ref.evaluate(cfg, w0, batch, nx)
                total, score, count = total + loss * len(ids), score + s, count + len(ids)
            out["eval"].append((total, score, float(count)))
        trainer = ref.Trainer(cfg, w0, steps_per_epoch, nx)
        steps = iter(captured["steps"])
        for n, _, _ in captured["calls"]:
            total, count = 0.0, 0
            for i in range(n):
                R, parts = next(steps)
                if fault == "replay":
                    R, parts = (R, parts) if i == 0 else first
                    first = (R, parts)
                if fault == "exchange":
                    parts = parts[:1]
                batches = []
                for ids in parts:
                    ids = kept(ids)
                    batches.append(refdata.make_batch(raw_train, ids, R, device) if len(ids)
                                   else None)
                rows = sum(0 if b is None else b["features"].shape[0] for b in batches)
                if fault == "unchanged":
                    saved = {k: v.clone() for k, v in trainer.params.items()}
                loss = trainer.step_parts(batches, seed)
                if fault == "unchanged":
                    trainer.params = saved
                if "grad" not in out:
                    out.update(first_step(trainer, w0))
                    first_batches = batches
                total, count = total + loss * rows, count + rows
            out["calls"].append((n, total, float(count)))
        out["change"] = compare.norms({k: trainer.params[k] - w0[k] for k in w0})
        for i in range(1, neighbours + 1):
            w = nudged(w0, seed + i, device)
            trainer = ref.Trainer(cfg, w, steps_per_epoch, nx)
            trainer.step_parts(first_batches, seed)
            out["first"].append(first_step(trainer, w))
    return out


def first_step(trainer, w0: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, float]]:
    """The first gradient's leaf norms, as the optimizer's state after one
    step gives it, and the change's since `w0`."""
    return {"grad": compare.norms({k: v / (1.0 - ref.ADAMAX_B1) for k, v in trainer.mu.items()}),
            "change1": compare.norms({k: trainer.params[k] - w0[k] for k in w0})}


def numbers(program: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, Any]:
    """The numbers a cell may compare (its limits file names those it does):
    - "eval_n", "train_n": the widest gap of an eval block's or a train
      call's count of questions (exact);
    - "eval_loss", "step_loss": the worst relative gap of an eval block's
      or a train call's loss sum (the train calls: the first step alone,
      and the block of the window's size);
    - "grad", "grad_median": the worst and the median leaf of the first
      gradient's norms;
    - "change1", "change": the median leaf of the change's norms after the
      first step and after all the captured steps (leaves whose reference
      gradient is nought to rounding left out).
    The first step's three ("grad", "grad_median", "change1") are each
    taken against the nearest of the reference's first steps: from the
    initial weights and from the nudged copies in reference["first"]. The
    first gradient has kinks: where a ReLU's input lies within rounding of
    zero (in about one seed in fifty a hidden unit of the classifier, whose
    flip moves its example's gradient by several per cent), any rounding,
    the program's or a nudge of one ulp, puts it on either side; the copies
    take both sides. "grad_median_exact" is the median leaf against the
    initial weights alone, never compared.
    Steps 2-9 carry Adamax's sign-like updates of coordinates whose
    gradient is rounding, so the change after them swings from seed to seed
    as far with the initial weights one ulp off as with the program; the
    worst leaf of the first gradient is one small leaf's rounding where it
    is the spatial edge-label bias. Also returned, never compared: the
    widest gap of an eval block's score (a sum of VQA scores, moved by one
    near-tie of two answers' logits), the change's worst leaf and the worst
    leaves' names."""
    evals = list(zip(program["eval"], reference["eval"]))
    calls = list(zip(program["calls"], reference["calls"]))
    moving = compare.moving(reference["grad"])
    firsts = [reference] + reference.get("first", [])
    grad, grad_at = min(compare.leaf_gap(program["grad"], r["grad"]) for r in firsts)
    medians = [statistics.median(compare.leaf_gaps(program["grad"], r["grad"]).values())
               for r in firsts]
    change1 = min(statistics.median(compare.leaf_gaps(program["change1"], r["change1"],
                                                      moving).values()) for r in firsts)
    gaps = compare.leaf_gaps(program["change"], reference["change"], moving)
    worst = max(gaps, key=gaps.get)
    return {"eval_n": max(abs(p[2] - r[2]) for p, r in evals),
            "eval_loss": max(compare.rel_gap(p[0], r[0]) for p, r in evals),
            "train_n": max(abs(p[2] - r[2]) for p, r in calls),
            "step_loss": max(compare.rel_gap(p[1], r[1]) for p, r in calls),
            "grad": grad, "grad_median": min(medians), "grad_median_exact": medians[0],
            "change": statistics.median(gaps.values()), "change1": change1,
            "eval_score": max(abs(p[1] - r[1]) for p, r in evals),
            "change_worst": gaps[worst], "grad_leaf": grad_at, "change_leaf": worst}


def run(ctx) -> Dict[str, Any]:
    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    if ctx.readings is not None:
        got = readings(ctx, ctx.readings)
        return None if got is None else {"readings": got}
    cell = Cell(ctx)
    captured = cell.capture()
    if ctx.trace:
        tracing.Trace(device).warm()
    sync(device)
    setup_s = time.time() - ctx.t0
    counters, trace = _window(cell, ctx.seconds,
                              float(mix["trace_after"]) if ctx.trace else None)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    steps_per_epoch = cell.steps_per_epoch
    raw = (cell.raw_train, cell.raw_val)
    lines = cell.lines.lines
    cell.free()
    if trace is not None:
        spans = trace.windows("train_pass") + trace.windows("eval_pass")
        counters["traced_window_ns"] = (min(s for s, _ in spans), max(e for _, e in spans))
    if distributed.world_size() > 1:  # the fullest card's peak, each card's busy time
        busy = trace.busy_ns(*counters["traced_window_ns"]) if trace is not None else None
        ranks = [None] * distributed.world_size()
        torch.distributed.all_gather_object(ranks, (peak, busy))
        peak = max(p for p, _ in ranks)
        if trace is not None:
            counters["busy_ns_ranks"] = [b for _, b in ranks]
        if distributed.rank() != 0:
            return None
    got = reference_outputs(ctx, raw, captured, steps_per_epoch, neighbours=NEIGHBOURS)
    nums = numbers(captured, got)
    counters.update(train_flops=flops.train_flops(cfg), eval_flops=flops.forward_flops(cfg),
                    train_batch=int(cfg["batch_size"]) // distributed.world_size(),
                    eval_batch=int(mix["program"]["eval_batch"]) // distributed.world_size())
    e2e = {"setup_s": setup_s}
    if counters["train_seconds"] > 0:
        e2e["train_qps"] = counters["train_questions"] / counters["train_seconds"]
    if counters["eval_seconds"] > 0:
        e2e["eval_qps"] = counters["eval_questions"] / counters["eval_seconds"]
    return {
        "numbers": nums,
        "attempted": counters["train_steps"] + counters["eval_batches"],
        "failed": 0,
        "end_to_end": e2e,
        "counters": counters,
        "trace": trace,
        "memory_peak_bytes": int(peak),
        "notes": lines + [
            f"window: {counters['passes']} epochs, {counters['train_steps']} train steps, "
            f"{counters['eval_batches']} eval batches; B1 launches train "
            f"{counters['b1_train_launches']} eval {counters['b1_eval_launches']}, B2 "
            f"{counters['b2_launches']}; traced epochs dropped for lost device records: "
            f"{counters['traces_dropped']}",
            f"worst leaves: gradient {nums['grad_leaf']}, change {nums['change_leaf']}",
            "not compared: " + ", ".join(f"{k} {v!r}" for k, v in nums.items()
                                         if k not in ctx.limits and isinstance(v, float))],
    }


def readings(ctx, faults: List[str]) -> Dict[str, Any]:
    """regat_bench/control.py's readings for one seed: the program's
    numbers against the f32 reference, the TF32 control's, and each fault's
    (by `reference_outputs`' names), each in the program's place."""
    cell = Cell(ctx)
    captured = cell.capture()
    raw, steps_per_epoch = (cell.raw_train, cell.raw_val), cell.steps_per_epoch
    cell.free()
    if distributed.rank() != 0:
        return None
    ref32 = reference_outputs(ctx, raw, captured, steps_per_epoch, neighbours=NEIGHBOURS)
    out = {"program": numbers(captured, ref32)}
    out["control"] = numbers(reference_outputs(ctx, raw, captured, steps_per_epoch, "tf32"),
                             ref32)
    for f in faults:
        out[f] = numbers(reference_outputs(ctx, raw, captured, steps_per_epoch, "f32", f),
                         ref32)
    return out
