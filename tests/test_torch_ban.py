"""The port's BAN fusion (tf_vqa_regat_tpu_torch/models/ban.py) against the
JAX package's `ban_apply` on the CPU, with the JAX parameters carried
across (params.py):

- eval: the joint embedding and the attention maps, at glimpse 2 and 4,
  over a batch with a partly padded and a fully padded example (whose maps
  must be uniform, not NaN);
- per-leaf gradients of a loss with random cotangents on both outputs
  against `jax.grad`, dropout off;
- dropout at 0.2: the draws in order with their shapes, against the JAX
  sites (the FCNet before every layer, and the second draw on the
  attention's visual projection), and their keep rate.

Tolerances: outputs atol/rtol 1e-5 and gradients atol/rtol 1e-4 (f32 sums
in another order through the bilinear einsums and the softmax over R*T).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu import nn as jnn
from tf_vqa_regat_tpu.models.ban import ban_apply, ban_init
from tf_vqa_regat_tpu_torch import nn as tnn
from tf_vqa_regat_tpu_torch.models.ban import BAN
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

B, R, T, V_DIM, Q_DIM = 3, 10, 14, 40, 32
OUT_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed=1):
    rng = np.random.RandomState(seed)
    num_boxes = np.array([R, 6, 0])  # whole, partly padded, fully padded
    roi_mask = np.arange(R)[None, :] < num_boxes[:, None]
    v = (rng.randn(B, R, V_DIM) * roi_mask[..., None]).astype(np.float32)
    q = rng.randn(B, T, Q_DIM).astype(np.float32)
    return v, q, roi_mask


def _models(glimpse, drop=0.0):
    params = ban_init(jax.random.PRNGKey(glimpse), V_DIM, Q_DIM, glimpse)
    port = BAN(V_DIM, Q_DIM, glimpse, torch.Generator().manual_seed(0), drop)
    load_jax_arrays(port, flatten_tree(jax.tree.map(np.asarray, params)))
    return params, port


@pytest.mark.parametrize("glimpse", [2, 4])
def test_eval_outputs_match_ban_apply(glimpse):
    params, port = _models(glimpse, drop=0.2)
    v, q, roi_mask = _inputs()
    want_joint, want_att = ban_apply(
        params, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask), 0.2, False, None
    )
    with torch.no_grad():
        joint, att = port.eval()(torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(roi_mask))
    assert joint.shape == (B, Q_DIM) and att.shape == (B, glimpse, R, T)
    assert torch.isfinite(joint).all() and torch.isfinite(att).all()
    np.testing.assert_allclose(att.numpy(), np.asarray(want_att), **OUT_TOL)
    np.testing.assert_allclose(joint.numpy(), np.asarray(want_joint), **OUT_TOL)
    # padded rois get no weight; the fully padded example attends uniformly
    assert not att[1, :, 6:].any()
    np.testing.assert_allclose(att[2].numpy(), np.full((glimpse, R, T), 1.0 / (R * T)), rtol=1e-6)


@pytest.mark.parametrize("glimpse", [2, 4])
def test_per_leaf_gradients_match_jax_grad(glimpse):
    params, port = _models(glimpse)
    v, q, roi_mask = _inputs(2)
    rng = np.random.RandomState(3)
    w_joint = rng.randn(B, Q_DIM).astype(np.float32)
    w_att = rng.randn(B, glimpse, R, T).astype(np.float32)

    def loss_fn(p):
        joint, att = ban_apply(
            p, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask), 0.0, True, None
        )
        return jnp.sum(joint * w_joint) + jnp.sum(att * w_att)

    want = flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(params)))
    joint, att = port.train()(torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(roi_mask))
    ((joint * torch.from_numpy(w_joint)).sum() + (att * torch.from_numpy(w_att)).sum()).backward()
    got = {k.replace(".", "/"): p.grad.numpy() for k, p in port.named_parameters()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL, err_msg=k)


def test_dropout_sites_and_keep_rate(monkeypatch):
    glimpse = 2
    params, port = _models(glimpse, drop=0.2)
    v, q, roi_mask = _inputs()

    want = []
    real_jax = jnn.dropout

    def jax_recorder(x, rate, train, rngs):
        if train and rate > 0.0:
            want.append((tuple(x.shape), rate))
        return real_jax(x, rate, train, rngs)

    monkeypatch.setattr(jnn, "dropout", jax_recorder)
    jax.eval_shape(
        lambda p: ban_apply(
            p, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask), 0.2, True,
            jnn.RngGen(jax.random.PRNGKey(0)),
        ),
        params,
    )

    sites, masks = [], []
    real = tnn.dropout_draw

    def recorder(shape, rate, generator, device):
        bits, t = real(shape, rate, generator, device)
        sites.append((tuple(shape), rate))
        masks.append(bits >= t)
        return bits, t

    monkeypatch.setattr(tnn, "dropout_draw", recorder)
    port.train()(
        torch.from_numpy(v), torch.from_numpy(q), torch.from_numpy(roi_mask),
        torch.Generator().manual_seed(5),
    )
    assert sites == want
    h3 = 3 * Q_DIM
    # att_v_net, the second draw on its output, att_q_net, then per glimpse
    # b_v_net, b_q_net and q_prj
    assert sites[:3] == [((B, R, V_DIM), 0.2), ((B, R, h3), 0.2), ((B, T, Q_DIM), 0.2)]
    assert len(sites) == 3 + 3 * glimpse
    kept = torch.cat([m.flatten() for m in masks]).double()
    p = 205.0 / 256.0
    assert abs(kept.mean().item() - p) < 3.0 * np.sqrt(p * (1 - p) / kept.numel())
