"""Train and eval steps (counterpart of tf_vqa_regat_tpu/train/step.py
`_train_core` and `_eval_core`): loss, gradients and the Adamax update for
one batch, or the eval metrics of one batch. The metrics stay on the device
as 0-d tensors: {"loss", "score", "n"}.

A train step's dropout masks come from a generator on the batch's device
seeded from (seed + 1, step), as the JAX step folds the step into
PRNGKey(seed + 1), so they depend only on the seed and the step; a
captured step (train/graphs.py) is handed its generators, re-seeded so
before each replay.

Gradient accumulation (`grad_accum` k > 1, JAX `_accum_grads`): the batch
splits into k strided microbatches, microbatch a holding rows a, a+k,
a+2k, ... (so a padded final batch spreads its invalid rows as JAX's
does). Each runs forward and backward on its own, with its own generator
(seed + 1, step, a); the gradient of its loss sum (the valid-count mean
times its valid count) adds into f32 buffers and its activations are freed
before the next. The sum over the batch's valid count, max 1, takes one
clip and one Adamax update. The metrics are the loss sum over that count,
the score sum and the count.

Data parallelism (a process group, parallel/): each rank computes the
gradient of its own rows' loss sum (`grad_sums`, its microbatches strided
over its local rows, which with B/dp divisible by k are its part of JAX's
global microbatches) and writes it, with its loss sum, score sum and valid
count, into one flat buffer (`FlatSums`); one all-reduce sums the buffer
over the ranks, and `apply_sums` divides the gradients by the global count
(max 1) before the per-tensor clip and Adamax, so the update is the one
JAX's SPMD step takes over the global batch (train/step.py:44-106 there).
No rank averages its own gradient first: the sharded store's padded tails
give the ranks different counts. On CUDA the step is two graphs with the
all-reduce between them (gloo collectives cannot be captured). A rank's
dropout generators are seeded by (seed + 1, step, microbatch, data index).
Eval sums the loss, score and count of a block over the ranks.

Tensor parallelism (dp x tp ranks, parallel/mesh.py): the sums are
all-reduced over the data group (the ranks of one model index), since the
tp ranks of a data group hold the same rows; a split leaf keeps its part in
the flat buffer, which the ranks of one data group lay out alike. At
tp > 1 the forward and backward passes hold collectives over the model
group, which a CUDA graph cannot capture here (gloo's cannot be captured at
all), so the steps run eagerly (`eager_reason`). So do the steps whose
forward pass gathers its rows over the data group (--ref_compat_q_att at
dp > 1), and, under --debug_nans, the train steps and in-training eval
passes (train/debug_nans.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.nn import step_generator, step_seed
from tf_vqa_regat_tpu_torch.parallel import distributed
from tf_vqa_regat_tpu_torch.parallel.mesh import Mesh, batch_slice
from tf_vqa_regat_tpu_torch.train.graphs import StepGraphs, to_device
from tf_vqa_regat_tpu_torch.train.loss import bce_with_logits_sum, vqa_score_sum
from tf_vqa_regat_tpu_torch.train.optim import Adamax

Batch = Dict[str, torch.Tensor]


def _metrics(logits: torch.Tensor, loss: torch.Tensor, batch: Batch) -> Dict[str, torch.Tensor]:
    return {
        "loss": loss.detach(),
        "score": vqa_score_sum(logits.detach(), batch["target"], batch["valid"]),
        "n": batch["valid"].to(torch.float32).sum(),
    }


def train_forward(
    model: ReGAT, batch: Batch, step: int, seed: int, microbatch: int = 0,
    generator=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, logits) of the train forward pass of step `step` (of its
    microbatch `microbatch` under gradient accumulation), its dropout masks
    drawn from `generator`, by default step_generator(seed + 1, step,
    device, microbatch)."""
    model.train()
    if generator is None:
        generator = step_generator(seed + 1, step, batch["features"].device, microbatch)
    logits = model(batch, generator)
    return bce_with_logits_sum(logits, batch["target"], batch["valid"]), logits


def microbatch(batch: Batch, a: int, k: int) -> Batch:
    """Rows a, a+k, a+2k, ... of every tensor of the batch (JAX's strided
    split: [B] reshaped to [B/k, k], the k axis in front)."""
    return {key: v[a::k].contiguous() for key, v in batch.items()}


def train_step(
    model: ReGAT, opt: Adamax, batch: Batch, step: int, seed: int, grad_accum: int = 1,
    generators=None,
) -> Dict[str, torch.Tensor]:
    """One optimizer step on `batch` -> its metrics. The dropout masks come
    from `generators`, one per microbatch, seeded by the caller (a captured
    step keeps its generators), or by default from train_forward's."""
    gens = generators or [None] * grad_accum
    if grad_accum == 1:
        loss, logits = train_forward(model, batch, step, seed, 0, gens[0])
        grads = torch.autograd.grad(loss, opt.params)
        opt.step(grads)
        return _metrics(logits, loss, batch)
    grads, loss_sum, score, n_sum = grad_sums(model, opt.params, batch, step, seed,
                                              grad_accum, gens)
    n = torch.clamp(n_sum, min=1.0)
    torch._foreach_div_(grads, n)
    opt.step(grads)
    return {"loss": loss_sum / n, "score": score, "n": n_sum}


def grad_sums(
    model: ReGAT, params, batch: Batch, step: int, seed: int, grad_accum: int = 1,
    generators=None, rank: int = 0,
):
    """(the gradients of the batch's loss sum w.r.t. `params`, the loss sum,
    the score sum, the valid count), over `grad_accum` strided microbatches
    run one after another, each with its generator (default:
    step_generator(seed + 1, step, device, microbatch, rank))."""
    gens = generators or [None] * grad_accum
    grads, loss_sum, score, n_sum = None, 0.0, 0.0, 0.0
    for a in range(grad_accum):
        mb = batch if grad_accum == 1 else microbatch(batch, a, grad_accum)
        gen = gens[a]
        if gen is None and rank:
            gen = step_generator(seed + 1, step, mb["features"].device, a, rank)
        loss, logits = train_forward(model, mb, step, seed, a, gen)
        m = _metrics(logits, loss, mb)
        g = torch.autograd.grad(loss * m["n"], params)
        del loss, logits  # this microbatch's activations go before the next
        if grads is None:
            grads = list(g)
        else:
            torch._foreach_add_(grads, g)
        loss_sum = loss_sum + m["loss"] * m["n"]
        score = score + m["score"]
        n_sum = n_sum + m["n"]
    return grads, loss_sum, score, n_sum


class FlatSums:
    """One f32 buffer on the parameters' device holding a step's gradient
    of every parameter (`grads`, views shaped as the parameters) and its
    loss sum, score sum and valid count (`sums`, the last 3 elements): what
    one all-reduce sums over the ranks."""

    def __init__(self, params, device: torch.device):
        sizes = [p.numel() for p in params]
        self.flat = torch.zeros(sum(sizes) + 3, dtype=torch.float32, device=device)
        self.grads = [v.view_as(p) for v, p in zip(self.flat[:-3].split(sizes), params)]
        self.sums = self.flat[-3:]

    @torch.no_grad()
    def write(self, grads, loss_sum, score, n) -> None:
        torch._foreach_copy_(self.grads, list(grads))
        self.sums.copy_(torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                                     device=self.flat.device)
                                     for x in (loss_sum, score, n)]))


def apply_sums(opt: Adamax, sums: FlatSums) -> Dict[str, torch.Tensor]:
    """The update from summed gradients: divided by the summed count (max 1),
    then the per-tensor clip and Adamax -> the metrics of the global batch.
    The buffer is read, not changed."""
    n = torch.clamp(sums.sums[2], min=1.0)
    opt.step(torch._foreach_div(sums.grads, n))
    return {"loss": sums.sums[0] / n, "score": sums.sums[1].clone(),
            "n": sums.sums[2].clone()}


def add_step(block: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor]) -> None:
    """Fold one step's metrics into a block's sums, in place, as JAX's
    scanned blocks fold them: loss_sum += loss * n, score, n, and `loss`
    the last step's loss that had examples (JAX train/step.py:269-276)."""
    block["loss_sum"] += m["loss"] * m["n"]
    block["score"] += m["score"]
    block["n"] += m["n"]
    block["loss"] = torch.where(m["n"] > 0, m["loss"], block["loss"])


def block_zeros(device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros((), device=device) for k in ("loss", "loss_sum", "score", "n")}


@torch.no_grad()
def eval_step(model: ReGAT, batch: Batch) -> Dict[str, torch.Tensor]:
    model.eval()
    logits = model(batch)
    return _metrics(logits, bce_with_logits_sum(logits, batch["target"], batch["valid"]), batch)


def gathers_rows(model: ReGAT) -> bool:
    """Whether `model`'s forward pass gathers its rows over the data group
    (--ref_compat_q_att at dp > 1, models/language.py::batch_axis_softmax)."""
    return model.q_att.data is not None


def eager_reason(mesh: Mesh, gather: bool = False, debug_nans: bool = False) -> Optional[str]:
    """Why a step of `mesh` runs eagerly on the card, or None (graphed):
    tp > 1, a forward pass that gathers its rows over the data group
    (`gather`, gathers_rows), or --debug_nans (`debug_nans`)."""
    if mesh.tp > 1:
        return (f"tp={mesh.tp}: each step runs eagerly (its forward and backward passes "
                f"hold collectives over the model group, which a CUDA graph does not "
                f"capture here)")
    if gather:
        return (f"--ref_compat_q_att at dp={mesh.dp}: each step runs eagerly (its "
                f"forward pass gathers the question-attention logits over the data "
                f"group, a collective a CUDA graph does not capture here)")
    if debug_nans:
        return ("--debug_nans: each train step and in-training eval pass runs eagerly "
                "(every module's output is checked for a non-finite value, and the "
                "backward runs under autograd's anomaly mode, neither of which a CUDA "
                "graph replay can do)")
    return None


def eager_line(mesh: Mesh, gather: bool = False, debug_nans: bool = False) -> Optional[str]:
    """The log line of eager_reason's reason, or None: `[tp] ...` at tp > 1,
    `[eager] ...` otherwise."""
    reason = eager_reason(mesh, gather, debug_nans)
    if reason is None:
        return None
    return f"[{'tp' if mesh.tp > 1 else 'eager'}] {reason}"


def resolve_graphed(mesh: Mesh, graphed: Optional[bool], gather: bool = False,
                    debug_nans: bool = False) -> Optional[bool]:
    """`graphed` for a step of `mesh`: False where eager_reason gives a
    reason, where an explicit True raises."""
    reason = eager_reason(mesh, gather, debug_nans)
    if reason is None:
        return graphed
    if graphed:
        raise ValueError(f"graphed steps are refused at {reason}")
    return False


def real_batches(blk: np.ndarray) -> int:
    """The real batches of an index block [K, B]: its leading rows with an
    entry, the rest being the tail's all -1 padding (JAX runs a batch when
    any(idx >= 0))."""
    return int((blk >= 0).any(axis=1).sum())


class TrainSteps:
    """The train steps of one model and optimizer, through train/graphs.py:
    on CUDA one graph per (R, grad_accum, compute dtype) whose replay
    gathers the batch from `store` by a static index vector (the device
    path) or reads a static copy of a host batch (`store` None), runs the
    step and updates the parameters. Each step's generators are re-seeded
    from (seed + 1, count, microbatch, rank), as step_generator seeds them.

    Under a process group (`mesh.group`) a step is the graph of this rank's
    gradient sums (`grad_sums` into `sums`, a FlatSums), the all-reduce of
    `sums`, and the graph of the update (`apply_sums`); a global index block
    is cut to this rank's rows (batch_slice) before it reaches the card."""

    def __init__(self, model: ReGAT, opt: Adamax, cfg: Config, device: torch.device,
                 store: Optional[DeviceStore] = None, graphed: Optional[bool] = None,
                 pool: Any = None, mesh: Optional[Mesh] = None):
        self.opt, self.store = opt, store
        self.seed, self.k, self.dtype = cfg.seed, cfg.grad_accum, cfg.compute_dtype
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else Mesh(dp=1)
        graphed = resolve_graphed(self.mesh, graphed, gathers_rows(model), cfg.debug_nans)
        seed, k, rank = self.seed, self.k, self.mesh.data

        def gather(key, inputs) -> Batch:
            return inputs if store is None else gather_batch(store, inputs["idx"], key[0])

        if not self.mesh.group:
            def step(key, inputs, generators) -> Dict[str, torch.Tensor]:
                return train_step(model, opt, gather(key, inputs), opt.count, seed, k,
                                  generators)

            self.sums = self.update = None
            self.graphs = StepGraphs(step, self.device, graphed, generators=k,
                                     keep=opt.snapshot, pool=pool)
            return
        sums = self.sums = FlatSums(opt.params, self.device)

        def local(key, inputs, generators) -> Dict[str, torch.Tensor]:
            sums.write(*grad_sums(model, opt.params, gather(key, inputs), opt.count, seed, k,
                                  generators, rank))
            return {}

        def update(key, inputs, generators) -> Dict[str, torch.Tensor]:
            return apply_sums(opt, sums)

        self.graphs = StepGraphs(local, self.device, graphed, generators=k, pool=pool)
        self.update = StepGraphs(update, self.device, graphed, keep=opt.snapshot,
                                 pool=self.graphs.pool)

    def step(self, R: int, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One optimizer step at roi count R -> its metrics (a graph's
        outputs: consume them before the next step)."""
        count = self.opt.count
        seeds = [step_seed(self.seed + 1, count, a, self.mesh.data) for a in range(self.k)]
        if self.sums is None:
            m = self.graphs((R, self.k, self.dtype), inputs, seeds)
        else:
            self.graphs((R, self.k, self.dtype), inputs, seeds)
            distributed.all_reduce_([self.sums.flat], group=self.mesh.data_group())
            m = self.update("update", {})
        self.opt.count = count + 1
        return m

    def block(self, R: int, blk: np.ndarray, nreal: int) -> Dict[str, torch.Tensor]:
        """The first `nreal` batches of the global index block `blk` [K, B],
        one step each, with one copy of this rank's rows to the card -> the
        block's metrics (add_step): JAX's scanned block, whose padded steps
        leave the state as it is."""
        blk = batch_slice(blk, self.mesh.data, self.mesh.dp)
        idx = to_device(blk[:nreal], self.device)
        acc = block_zeros(self.device)
        for j in range(nreal):
            add_step(acc, self.step(R, {"idx": idx[j]}))
        return acc

    def batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        """One step on a batch of the host path -> a block of one."""
        acc = block_zeros(self.device)
        add_step(acc, self.step(batch["features"].shape[1], batch))
        return acc


class EvalSteps:
    """The eval steps of one model, through train/graphs.py: one graph per
    R, fed an index vector into `store` or a host batch. Under a process
    group each rank runs its rows of a block and the block's loss sum,
    score and count are summed over the data group."""

    def __init__(self, model: ReGAT, device: torch.device, store: Optional[DeviceStore] = None,
                 graphed: Optional[bool] = None, pool: Any = None,
                 mesh: Optional[Mesh] = None, debug_nans: bool = False):
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else Mesh(dp=1)
        graphed = resolve_graphed(self.mesh, graphed, gathers_rows(model), debug_nans)

        def step(R, inputs, generators) -> Dict[str, torch.Tensor]:
            batch = inputs if store is None else gather_batch(store, inputs["idx"], R)
            return eval_step(model, batch)

        self.graphs = StepGraphs(step, self.device, graphed, pool=pool)

    def block(self, R: int, blk: np.ndarray) -> Dict[str, torch.Tensor]:
        """The metrics of the index block `blk` [K, B] as JAX's eval block
        gives them: score and n summed, loss the valid-weighted mean; a
        block of one is the step's own metrics. Padded batches do not run:
        they add nothing."""
        nreal = real_batches(blk)
        idx = to_device(batch_slice(blk, self.mesh.data, self.mesh.dp)[:nreal], self.device)
        if blk.shape[0] == 1 and not self.mesh.group:
            return self.graphs(R, {"idx": idx[0]})
        acc = block_zeros(self.device)
        for j in range(nreal):
            add_step(acc, self.graphs(R, {"idx": idx[j]}))
        return self._summed(acc)

    def batch(self, batch: Batch) -> Dict[str, torch.Tensor]:
        m = self.graphs(batch["features"].shape[1], batch)
        if not self.mesh.group:
            return m
        acc = block_zeros(self.device)
        add_step(acc, m)
        return self._summed(acc)

    def _summed(self, acc: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A block's metrics from its sums, summed over the ranks."""
        sums = torch.stack([acc["loss_sum"], acc["score"], acc["n"]])
        distributed.all_reduce_([sums], group=self.mesh.data_group())
        return {"loss": sums[0] / torch.clamp(sums[2], min=1.0), "score": sums[1],
                "n": sums[2]}
