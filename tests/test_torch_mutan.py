"""The port's MuTAN fusion (tf_vqa_regat_tpu_torch/models/mutan.py) against
the JAX package's `mutan_apply` and `_mutan_block_apply` on the CPU, with
the JAX parameters carried across (params.py), at rank 3 (MM_DIM is fixed
at 1200):

- each formulation of the Tucker block against the JAX block fed the same
  question shape: [b, 1, d] takes the reassociated branch on both sides,
  [b, R, d] (the question already broadcast) the naive one;
- the port's two formulations against each other on the same inputs;
- the whole fusion in eval (logits and attention, with a fully padded
  example that must attend uniformly) and its per-leaf gradients against
  `jax.grad`, dropout off;
- which formulation runs: eval, train with input dropout (naive, one
  question mask per roi), train under `mutan_shared_qdrop` (reassociated,
  one question mask per example) and train at dropout 0 (reassociated);
  the draws' shapes and rates against the JAX sites.

Tolerances: outputs atol/rtol 1e-5 relative to the largest |output| (f32
sums of 1200-3600 terms in another order); the two formulations rel 1e-5
of the largest |z|; gradients atol/rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu import nn as jnn
from tf_vqa_regat_tpu.models import mutan as jmutan
from tf_vqa_regat_tpu_torch import nn as tnn
from tf_vqa_regat_tpu_torch.models.mutan import MM_DIM, MutanBlock, MuTAN
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

B, R, V_DIM, Q_DIM, NUM_ANS, RANK, GLIMPSE = 3, 10, 40, 32, 17, 3, 2
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
BRANCH_RTOL = 1e-5


def _close(got, want, rtol=1e-5):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=rtol * scale, rtol=rtol)


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    num_boxes = np.array([R, 6, 0])  # whole, partly padded, fully padded
    roi_mask = np.arange(R)[None, :] < num_boxes[:, None]
    v = (rng.randn(B, R, V_DIM) * roi_mask[..., None]).astype(np.float32)
    q = rng.randn(B, Q_DIM).astype(np.float32)
    return v, q, roi_mask


def _load(port, params):
    load_jax_arrays(port, flatten_tree(jax.tree.map(np.asarray, params)))
    return port


def _block(seed=0, drop_input=0.0, shared_qdrop=False):
    params = jmutan._mutan_block_init(jax.random.PRNGKey(seed), Q_DIM, V_DIM, 24, RANK)
    port = MutanBlock(Q_DIM, V_DIM, 24, RANK, torch.Generator().manual_seed(0),
                      drop_input, shared_qdrop)
    return params, _load(port, params)


def _spy_branches(monkeypatch):
    """A list that records the name of every formulation a block runs."""
    calls = []
    for name in ("naive", "reassociated"):
        real = getattr(MutanBlock, name)
        monkeypatch.setattr(
            MutanBlock, name,
            lambda self, h0, h1, real=real, name=name: calls.append(name) or real(self, h0, h1),
        )
    return calls


def _fusion(drop=0.0, shared_qdrop=False):
    params = jmutan.mutan_init(jax.random.PRNGKey(2), V_DIM, Q_DIM, NUM_ANS, RANK, GLIMPSE)
    port = MuTAN(V_DIM, Q_DIM, NUM_ANS, RANK, GLIMPSE, torch.Generator().manual_seed(0),
                 drop, shared_qdrop)
    return params, _load(port, params)


@pytest.mark.parametrize("branch", ["reassociated", "naive"])
def test_block_branch_matches_jax_block(monkeypatch, branch):
    params, port = _block()
    v, q, _ = _inputs()
    x0 = q[:, None, :] if branch == "reassociated" else np.repeat(q[:, None, :], R, axis=1)
    want = jmutan._mutan_block_apply(
        params, jnp.asarray(x0), jnp.asarray(v), RANK, 0.0, False, None, jnp.float32
    )
    calls = _spy_branches(monkeypatch)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x0), torch.from_numpy(v))
    assert calls == [branch]
    assert got.shape == (B, R, 24)
    _close(got.numpy(), np.asarray(want))


def test_the_two_formulations_agree():
    _, port = _block(1)
    v, q, _ = _inputs(2)
    with torch.no_grad():
        h0 = port.linear0(torch.from_numpy(q)[:, None, :])
        h1 = port.linear1(torch.from_numpy(v))
        naive, reassociated = port.naive(h0, h1), port.reassociated(h0, h1)
    assert naive.shape == reassociated.shape == (B, R, MM_DIM)
    err = (naive - reassociated).abs().max() / naive.abs().max()
    assert err.item() <= BRANCH_RTOL


def test_eval_outputs_match_mutan_apply():
    params, port = _fusion(drop=0.2)
    v, q, roi_mask = _inputs()
    want_logits, want_alpha = jmutan.mutan_apply(
        params, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask), 0.2, False, None,
        rank=RANK,
    )
    with torch.no_grad():
        logits, alpha = port.eval()(torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(roi_mask))
    assert logits.shape == (B, NUM_ANS) and alpha.shape == (B, R, GLIMPSE)
    assert torch.isfinite(logits).all()
    _close(alpha.numpy(), np.asarray(want_alpha))
    _close(logits.numpy(), np.asarray(want_logits))
    assert not alpha[1, 6:].any()
    np.testing.assert_allclose(alpha[2].numpy(), np.full((R, GLIMPSE), 1.0 / R), rtol=1e-6)


@pytest.mark.parametrize("branch", ["reassociated", "naive"])
def test_per_leaf_gradients_match_jax_grad(branch):
    """The fusion (attention block reassociated, answer block naive), or the
    attention block alone fed the broadcast question (naive)."""
    v, q, roi_mask = _inputs(3)
    rng = np.random.RandomState(4)
    if branch == "reassociated":
        params, port = _fusion()
        w = [rng.randn(B, NUM_ANS).astype(np.float32), rng.randn(B, R, GLIMPSE).astype(np.float32)]

        def jax_out(p):
            return jmutan.mutan_apply(p, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask),
                                      0.0, True, None, rank=RANK)

        outs = port.train()(torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(roi_mask))
    else:
        params, port = _block(5)
        x0 = np.repeat(q[:, None, :], R, axis=1)
        w = [rng.randn(B, R, 24).astype(np.float32)]

        def jax_out(p):
            return (jmutan._mutan_block_apply(p, jnp.asarray(x0), jnp.asarray(v), RANK, 0.0,
                                              True, None, jnp.float32),)

        outs = (port.train()(torch.from_numpy(x0), torch.from_numpy(v)),)

    def loss_fn(p):
        return sum(jnp.sum(o * c) for o, c in zip(jax_out(p), w))

    want = flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, w)).backward()
    got = {k.replace(".", "/"): p.grad.numpy() for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL, err_msg=k)


@pytest.mark.parametrize(
    "train, drop, shared_qdrop, want_branch",
    [(False, 0.2, False, "reassociated"), (True, 0.2, False, "naive"),
     (True, 0.2, True, "reassociated"), (True, 0.0, False, "reassociated")],
    ids=["eval", "train", "shared_qdrop", "dropout0"],
)
def test_branch_and_dropout_sites(monkeypatch, train, drop, shared_qdrop, want_branch):
    params, port = _fusion(drop, shared_qdrop)
    v, q, roi_mask = _inputs()
    calls = _spy_branches(monkeypatch)
    jax_sites = []
    real_jax = jnn.dropout

    def jax_recorder(x, rate, train, rngs):
        if train and rate > 0.0:
            jax_sites.append((tuple(x.shape), rate))
        return real_jax(x, rate, train, rngs)

    monkeypatch.setattr(jnn, "dropout", jax_recorder)
    jax.eval_shape(
        lambda p: jmutan.mutan_apply(
            p, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask), drop, train,
            jnn.RngGen(jax.random.PRNGKey(0)), rank=RANK, shared_qdrop=shared_qdrop,
        ),
        params,
    )
    sites, masks = [], []
    real_draw = tnn.dropout_draw

    def recorder(shape, rate, generator, device):
        bits, t = real_draw(shape, rate, generator, device)
        sites.append((tuple(shape), rate))
        masks.append(bits >= t)
        return bits, t

    monkeypatch.setattr(tnn, "dropout_draw", recorder)
    port.train(train)(
        torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(roi_mask),
        torch.Generator().manual_seed(6),
    )
    # the attention block's branch; the answer block's inputs are 2-D: naive
    assert calls == [want_branch, "naive"]
    assert sites == jax_sites
    if not train or drop == 0.0:
        assert sites == []
        return
    q_rows = 1 if shared_qdrop else R
    assert sites == [((B, q_rows, MM_DIM), 0.1), ((B, R, MM_DIM), 0.1),
                     ((B, MM_DIM), 0.1), ((B, MM_DIM), 0.1)]
    if not shared_qdrop:  # one mask per roi: the rois of one example differ
        assert not torch.equal(masks[0][:, 0], masks[0][:, 1])
    kept = torch.cat([m.flatten() for m in masks]).double()
    p = 230.0 / 256.0
    assert abs(kept.mean().item() - p) < 3.0 * np.sqrt(p * (1 - p) / kept.numel())
