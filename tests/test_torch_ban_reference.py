"""The port's ReGAT with BAN fusion against the benchmark's plain-torch
reference (regat_bench/reference, fusion/ban.py) on the CPU, at small
widths (regat_bench/tests/small.py's, glimpse 2 and 4), from one seeded
weight set (regat_bench.weights.make_weights) loaded strictly into the
program: the answer logits, the BCE loss of each example and every leaf's
gradient, with dropout off and at 0.2 (both sides draw from generators
seeded alike, in the same order), and the frozen set against the program's
`trainable_mask`.

Tolerances, each with what it covers (the program's largest reading at
these sizes, then the reference with TF32-rounded operands against the f32
reference, the least reading, both over the four cases):
- logits: max |gap| over the largest |logit|, 2e-5 (program <= 5.5e-7, f32
  sums in another order; TF32 >= 5.9e-4);
- loss: the largest relative gap of one example's loss, 1e-6 (program <=
  2.3e-7; TF32 >= 2.7e-6);
- gradients: each leaf's ||gap|| over the larger of its reference norm and
  the median leaf's, 1e-4 (program <= 4.1e-6, at the pos-FC kernels, which
  the reference sums in float64 and the program's CPU path in float32;
  TF32 >= 0.021).
`test_tf32_operands_fail_each_tolerance` shows the TF32 reference failing
each of the three.
"""

import statistics

import numpy as np
import pytest
import torch

from regat_bench import inputs, manifest, port
from regat_bench.reference import data as refdata
from regat_bench.reference import regat as ref
from regat_bench.tests import small
from regat_bench.weights import make_weights
from tf_vqa_regat_tpu_torch.models.regat import trainable_mask
from tf_vqa_regat_tpu_torch.train.loss import bce_with_logits_sum

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

SEED = 2_147_483_999
CPU = torch.device("cpu")
LOGITS_TOL, LOSS_TOL, GRAD_TOL = 2e-5, 1e-6, 1e-4
CASES = [(2, 0.0), (2, 0.2), (4, 0.0), (4, 0.2)]


def _cfg(glimpse, dropout):
    return dict(manifest.Manifest().config("ban_vqa"), **small.CONFIG, ban_glimpse=glimpse,
                dropout=dropout)


def _setup(glimpse, dropout):
    """(cfg, weights, one batch of 16 questions, the program's model)."""
    cfg = _cfg(glimpse, dropout)
    weights = make_weights(cfg, SEED, CPU)
    raw = inputs.make_split(cfg, SEED, 16, 8)
    batch = refdata.make_batch(raw, np.arange(16), cfg["max_boxes"], CPU)
    ds = port.dataset(raw, "train", cfg["relation_type"])
    return cfg, weights, batch, port.model(port.config(cfg, SEED), ds, weights, CPU)


def _per_example(logits, target):
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).sum(-1)


def _program(model, batch):
    """(logits, per-example losses, {leaf: gradient}) of the program's
    train forward and its BCE loss."""
    logits = model.train()(batch, torch.Generator().manual_seed(77))
    valid = torch.ones(logits.shape[0], dtype=torch.bool)
    loss = bce_with_logits_sum(logits, batch["target"], valid)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    return logits.detach(), _per_example(logits.detach(), batch["target"]), dict(zip(names, grads))


def _reference(cfg, weights, batch, precision="f32"):
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    nx = ref.Numerics(precision)
    with nx.active(CPU):
        logits = ref.Model(cfg, leaves, nx).forward(batch, torch.Generator().manual_seed(77))
        loss = ref.bce_loss(logits, batch["target"])
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return logits.detach(), _per_example(logits.detach(), batch["target"]), dict(zip(leaves, grads))


def _gaps(got, want):
    """(logits gap, worst example's loss gap, {leaf: gradient gap})."""
    (lg, eg, gg), (lw, ew, gw) = got, want
    med = statistics.median(float(g.norm()) for g in gw.values())
    grads = {k: float((gg[k] - gw[k]).norm()) / max(float(gw[k].norm()), med) for k in gw}
    return (float((lg - lw).abs().max() / lw.abs().max()),
            float(((eg - ew).abs() / ew.abs()).max()), grads)


@pytest.fixture(scope="module", params=CASES, ids=[f"glimpse{g}-dropout{d}" for g, d in CASES])
def case(request):
    cfg, weights, batch, model = _setup(*request.param)
    return cfg, weights, batch, model, _reference(cfg, weights, batch)


def test_program_matches_the_reference(case):
    cfg, weights, batch, model, want = case
    got = _program(model, batch)
    assert sorted(got[2]) == sorted(want[2])
    logits, loss, grads = _gaps(got, want)
    assert logits <= LOGITS_TOL and loss <= LOSS_TOL, (logits, loss)
    worst = max(grads, key=grads.get)
    assert grads[worst] <= GRAD_TOL, (worst, grads[worst])


def test_tf32_operands_fail_each_tolerance(case):
    cfg, weights, batch, model, want = case
    logits, loss, grads = _gaps(_reference(cfg, weights, batch, "tf32"), want)
    assert logits > LOGITS_TOL and loss > LOSS_TOL and max(grads.values()) > GRAD_TOL, \
        (logits, loss, max(grads.values()))


def test_frozen_set_is_the_programs():
    cfg, weights, batch, model = _setup(4, 0.2)
    mask = trainable_mask(model, False)
    assert sorted(ref.frozen(cfg, list(weights))) == sorted(k for k, v in mask.items() if not v)
    assert "joint_emb.h_bias" in ref.frozen(cfg, list(weights))
