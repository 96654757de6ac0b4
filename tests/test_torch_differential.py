"""Independent-substrate differential for the net-new fusion families.

BAN and MuTAN have no reference code (the TF reference accepts the flags but
hardwires BUTD — reference main.py:51-52, rel_graph_net.py:106), so their
numpy golden oracles (tests/test_golden.py) were derived by the same author
from the same equations. This file upgrades that to a SECOND implementation
in a different substrate (round-3 verdict item 6): the upstream ban-vqa
BCNet/BiAttention computation transcribed in PyTorch with its native
structure — ``torch.nn.utils.weight_norm(dim=None)`` (the scalar-g
whole-tensor norm the jax side reimplements in ops/weight_norm.py),
broadcast-multiply + ``torch.matmul`` chains instead of einsums, torch's own
softmax — and the block-lib Mutan equations (models/mutan.py:10-12) in torch
Linears. Weights are copied leaf-for-leaf; eval-mode outputs must agree.

An index-order or transpose transcription error in the jax einsums cannot
cancel here: the torch forward never uses einsum and its weight layout is
the torch Linear convention ([out, in]), so every copy transposes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_vqa_regat_tpu.models.ban import ban_apply, ban_init  # noqa: E402
from tf_vqa_regat_tpu.models.mutan import (  # noqa: E402
    MM_DIM,
    mutan_apply,
    mutan_init,
)

from torch import nn  # noqa: E402
from torch.nn.utils import weight_norm  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _copy_wn_linear(linear, wn_params):
    """Our {v: [in, out], g: scalar, b} -> a torch weight_norm'd Linear
    (weight_v is [out, in]; g is the whole-tensor norm, transpose-invariant)."""
    with torch.no_grad():
        linear.weight_v.copy_(_t(wn_params["v"]).T)
        linear.weight_g.copy_(
            torch.as_tensor(float(wn_params["g"])).reshape(linear.weight_g.shape)
        )
        linear.bias.copy_(_t(wn_params["b"]))


def _copy_linear(linear, p):
    with torch.no_grad():
        linear.weight.copy_(_t(p["w"]).T)
        linear.bias.copy_(_t(p["b"]))


class TFCNet(nn.Module):
    """ban-vqa fc.py: [Dropout] -> weight_norm(Linear, dim=None) -> act."""

    def __init__(self, dims, act="ReLU"):
        super().__init__()
        layers = []
        for i in range(len(dims) - 1):
            layers.append(weight_norm(nn.Linear(dims[i], dims[i + 1]), dim=None))
            if act:
                layers.append(getattr(nn, act)())
        self.main = nn.Sequential(*layers)

    def copy_from(self, fc_params):
        linears = [m for m in self.main if isinstance(m, nn.Linear)]
        assert len(linears) == len(fc_params["layers"])
        for linear, lp in zip(linears, fc_params["layers"]):
            _copy_wn_linear(linear, lp)

    def forward(self, x):
        return self.main(x)


class TBCNet(nn.Module):
    """ban-vqa bc.py BCNet. h_out path (attention logits): h_mat broadcast
    multiply + matmul; forward_with_weights (k=1 pooling path): the
    transpose/matmul sandwich."""

    def __init__(self, v_dim, q_dim, h_dim, h_out, k):
        super().__init__()
        self.k, self.h_out = k, h_out
        self.v_net = TFCNet([v_dim, h_dim * k])
        self.q_net = TFCNet([q_dim, h_dim * k])
        if h_out is not None:
            self.h_mat = nn.Parameter(torch.empty(1, h_out, 1, h_dim * k))
            self.h_bias = nn.Parameter(torch.empty(1, h_out, 1, 1))

    def forward(self, v, q):  # -> [b, h_out, R, T] attention logits
        v_ = self.v_net(v).unsqueeze(1)  # b,1,R,hk
        q_ = self.q_net(q)  # b,T,hk
        h_ = v_ * self.h_mat  # b,g,R,hk
        return torch.matmul(h_, q_.unsqueeze(1).transpose(2, 3)) + self.h_bias

    def forward_with_weights(self, v, q, w):  # -> [b, h_dim]
        v_ = self.v_net(v).transpose(1, 2).unsqueeze(2)  # b,h,1,R
        q_ = self.q_net(q).transpose(1, 2).unsqueeze(3)  # b,h,T,1
        logits = torch.matmul(torch.matmul(v_, w.unsqueeze(1)), q_)
        return logits.squeeze(3).squeeze(2)


class TBAN(nn.Module):
    """Upstream ReGAT fusion.BAN forward (no counter — models/ban.py
    docstring): BiAttention maps, then per-glimpse forward_with_weights +
    residual q_prj updates, joint = q.sum(1)."""

    def __init__(self, v_dim, q_dim, glimpse):
        super().__init__()
        h = q_dim
        self.glimpse = glimpse
        self.att = weight_norm(
            TBCNet(v_dim, q_dim, h, glimpse, k=3), name="h_mat", dim=None
        )
        self.b_net = nn.ModuleList(
            TBCNet(v_dim, q_dim, h, None, k=1) for _ in range(glimpse)
        )
        self.q_prj = nn.ModuleList(TFCNet([h, h], act="") for _ in range(glimpse))

    def copy_from(self, p):
        self.att.v_net.copy_from(p["att_v_net"])
        self.att.q_net.copy_from(p["att_q_net"])
        g, hk = np.asarray(p["h_mat"]["v"]).shape
        with torch.no_grad():
            self.att.h_mat_v.copy_(_t(p["h_mat"]["v"]).reshape(1, g, 1, hk))
            self.att.h_mat_g.copy_(
                torch.as_tensor(float(p["h_mat"]["g"])).reshape(
                    self.att.h_mat_g.shape
                )
            )
            self.att.h_bias.copy_(_t(p["h_bias"]).reshape(1, g, 1, 1))
        for gi in range(self.glimpse):
            self.b_net[gi].v_net.copy_from(p["b_v_net"][gi])
            self.b_net[gi].q_net.copy_from(p["b_q_net"][gi])
            self.q_prj[gi].copy_from(p["q_prj"][gi])

    def forward(self, v, q):
        b, R, _ = v.shape
        T = q.shape[1]
        logits = self.att(v, q)  # b,g,R,T
        # BiAttention's v_mask: zero-feature rois filled with -inf pre-softmax
        mask = (v.abs().sum(2) == 0)[:, None, :, None].expand(logits.shape)
        logits = logits.masked_fill(mask, float("-inf"))
        att = torch.softmax(logits.view(b, self.glimpse, R * T), dim=2).view(
            b, self.glimpse, R, T
        )
        for g in range(self.glimpse):
            b_emb = self.b_net[g].forward_with_weights(v, q, att[:, g])
            q = self.q_prj[g](b_emb.unsqueeze(1)) + q
        return q.sum(1), att


def test_ban_matches_torch_transcription():
    b, R, T, v_dim, q_dim, glimpse = 2, 12, 14, 48, 32, 4
    params = ban_init(jax.random.PRNGKey(0), v_dim, q_dim, glimpse)
    rng = np.random.RandomState(1)
    v = rng.randn(b, R, v_dim).astype(np.float32)
    q = rng.randn(b, T, q_dim).astype(np.float32)
    num_boxes = np.array([R, R - 5])
    roi_mask = np.arange(R)[None, :] < num_boxes[:, None]
    v[~roi_mask] = 0.0  # padded rois are zero rows (the store contract)

    got_joint, got_att = ban_apply(
        params, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask),
        drop_rate=0.2, train=False, rngs=None,
    )

    tban = TBAN(v_dim, q_dim, glimpse)
    tban.copy_from(params)
    tban.eval()
    with torch.no_grad():
        want_joint, want_att = tban(_t(v), _t(q))

    np.testing.assert_allclose(
        np.asarray(got_att), want_att.numpy(), rtol=2e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got_joint), want_joint.numpy(), rtol=2e-4, atol=1e-4
    )


class TMutanBlock(nn.Module):
    """block-lib Mutan equations (models/mutan.py:10-12): rank-R Tucker
    factorization z = sum_r (W0_r L0 x0) * (W1_r L1 x1), out = Lout z."""

    def __init__(self, d0, d1, out, rank):
        super().__init__()
        self.rank = rank
        self.linear0 = nn.Linear(d0, MM_DIM)
        self.linear1 = nn.Linear(d1, MM_DIM)
        self.merge0 = nn.Linear(MM_DIM, MM_DIM * rank)
        self.merge1 = nn.Linear(MM_DIM, MM_DIM * rank)
        self.linear_out = nn.Linear(MM_DIM, out)

    def copy_from(self, p):
        for name in ("linear0", "linear1", "merge0", "merge1", "linear_out"):
            _copy_linear(getattr(self, name), p[name])

    def forward(self, x0, x1):
        m = self.merge0(self.linear0(x0)) * self.merge1(self.linear1(x1))
        z = m.view(*m.shape[:-1], self.rank, MM_DIM).sum(-2)
        return self.linear_out(z)


class TMuTAN(nn.Module):
    """MuTAN_Attention + answer fusion (models/mutan.py docstring): Tucker
    attention block with the question EXPANDED per roi (the upstream block
    lib flattens rois into the batch — no broadcasting shortcut on this
    side), glimpse MLP, masked roi softmax, glimpse-weighted visual concat,
    second Tucker block scoring answers."""

    def __init__(self, v_dim, q_dim, num_ans, rank, glimpse):
        super().__init__()
        from tf_vqa_regat_tpu.models.mutan import ATT_DIM, MLP_HID

        self.att_fusion = TMutanBlock(q_dim, v_dim, ATT_DIM, rank)
        self.att_linear0 = TFCNet([ATT_DIM, MLP_HID], act="")
        self.att_linear1 = TFCNet([MLP_HID, glimpse], act="")
        self.out_fusion = TMutanBlock(q_dim, v_dim * glimpse, num_ans, rank)

    def copy_from(self, p):
        self.att_fusion.copy_from(p["att_fusion"])
        self.att_linear0.copy_from(p["att_linear0"])
        self.att_linear1.copy_from(p["att_linear1"])
        self.out_fusion.copy_from(p["out_fusion"])

    def forward(self, v, q, roi_mask):
        b, R, _ = v.shape
        q_per_roi = q.unsqueeze(1).expand(b, R, q.shape[-1])
        alpha = self.att_linear1(self.att_linear0(self.att_fusion(q_per_roi, v)))
        alpha = alpha.masked_fill(~roi_mask.unsqueeze(-1), float("-inf"))
        alpha = torch.softmax(alpha, dim=1)  # b,R,glimpse
        v_out = torch.cat(
            [(alpha[..., g:g + 1] * v).sum(1) for g in range(alpha.shape[-1])],
            dim=-1,
        )
        return self.out_fusion(q, v_out), alpha


def test_mutan_matches_torch_transcription():
    b, R, v_dim, q_dim, num_ans, rank, glimpse = 2, 10, 40, 32, 17, 3, 2
    params = mutan_init(
        jax.random.PRNGKey(2), v_dim, q_dim, num_ans, rank, glimpse
    )
    rng = np.random.RandomState(3)
    v = rng.randn(b, R, v_dim).astype(np.float32)
    q = rng.randn(b, q_dim).astype(np.float32)
    num_boxes = np.array([R, R - 4])
    roi_mask = np.arange(R)[None, :] < num_boxes[:, None]
    v[~roi_mask] = 0.0

    got_logits, got_alpha = mutan_apply(
        params, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask),
        drop_rate=0.2, train=False, rngs=None, rank=rank,
    )

    tm = TMuTAN(v_dim, q_dim, num_ans, rank, glimpse)
    tm.copy_from(params)
    tm.eval()
    with torch.no_grad():
        want_logits, want_alpha = tm(_t(v), _t(q), torch.from_numpy(roi_mask))

    np.testing.assert_allclose(
        np.asarray(got_alpha), want_alpha.numpy(), rtol=2e-4, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got_logits), want_logits.numpy(), rtol=2e-4, atol=2e-3
    )


# ---------------------------------------------------------------------------
# Gradient-level differential (round-4 verdict item 4): the eval-forward
# match above cannot see a training-path bug — dropout placement aside (off
# in both substrates here), the weight-norm scalar-g reparameterization has
# its own gradient flow (dL/dv couples through g/||v|| AND the dL/dg
# projection), and a transposed-layout error in a backward einsum would not
# perturb the forward. Copied weights, same batch, torch loss.backward() vs
# jax.grad, per-leaf agreement after mapping torch's [out, in] layout back.
# ---------------------------------------------------------------------------


def _wn_linear_grads(linear):
    """Torch weight_norm'd Linear grads -> our {v: [in,out], g, b} layout."""
    return {
        "v": linear.weight_v.grad.numpy().T,
        "g": np.float32(linear.weight_g.grad.reshape(())),
        "b": linear.bias.grad.numpy(),
    }


def _fcnet_grads(tfc):
    linears = [m for m in tfc.main if isinstance(m, nn.Linear)]
    return {"layers": [_wn_linear_grads(l) for l in linears]}


def _linear_grads(linear):
    return {"w": linear.weight.grad.numpy().T, "b": linear.bias.grad.numpy()}


def _assert_grad_trees_close(got_tree, want_tree, rtol=1e-3, atol=2e-5):
    got_leaves, got_def = jax.tree_util.tree_flatten(got_tree)
    want_leaves, want_def = jax.tree_util.tree_flatten(want_tree)
    assert got_def == want_def, (got_def, want_def)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(
            np.asarray(g, np.float64), np.asarray(w, np.float64),
            rtol=rtol, atol=atol,
        )


def test_ban_gradients_match_torch_transcription():
    b, R, T, v_dim, q_dim, glimpse = 2, 12, 14, 48, 32, 4
    params = ban_init(jax.random.PRNGKey(0), v_dim, q_dim, glimpse)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    rng = np.random.RandomState(1)
    v = rng.randn(b, R, v_dim).astype(np.float32)
    q = rng.randn(b, T, q_dim).astype(np.float32)
    num_boxes = np.array([R, R - 5])
    roi_mask = np.arange(R)[None, :] < num_boxes[:, None]
    v[~roi_mask] = 0.0
    # fixed random cotangents: every output element backpropagates, so a
    # gradient error anywhere in (joint, att) is observable
    w_j = rng.randn(b, q_dim).astype(np.float32)
    w_a = rng.randn(b, glimpse, R, T).astype(np.float32)

    def loss_fn(p):
        joint, att = ban_apply(
            p, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask),
            drop_rate=0.2, train=False, rngs=None,
        )
        return jnp.sum(joint * w_j) + jnp.sum(att * w_a)

    got = jax.device_get(jax.grad(loss_fn)(params))

    tban = TBAN(v_dim, q_dim, glimpse)
    tban.copy_from(params)
    tban.eval()
    joint, att = tban(_t(v), _t(q))
    ((joint * _t(w_j)).sum() + (att * _t(w_a)).sum()).backward()
    g_, hk = np.asarray(params["h_mat"]["v"]).shape
    want = {
        "att_v_net": _fcnet_grads(tban.att.v_net),
        "att_q_net": _fcnet_grads(tban.att.q_net),
        "h_mat": {
            "v": tban.att.h_mat_v.grad.numpy().reshape(g_, hk),
            "g": np.float32(tban.att.h_mat_g.grad.reshape(())),
        },
        "h_bias": tban.att.h_bias.grad.numpy().reshape(g_),
        "b_v_net": [_fcnet_grads(n.v_net) for n in tban.b_net],
        "b_q_net": [_fcnet_grads(n.q_net) for n in tban.b_net],
        "q_prj": [_fcnet_grads(n) for n in tban.q_prj],
    }
    _assert_grad_trees_close(got, want)


def test_mutan_gradients_match_torch_transcription():
    b, R, v_dim, q_dim, num_ans, rank, glimpse = 2, 10, 40, 32, 17, 3, 2
    params = mutan_init(
        jax.random.PRNGKey(2), v_dim, q_dim, num_ans, rank, glimpse
    )
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)
    rng = np.random.RandomState(3)
    v = rng.randn(b, R, v_dim).astype(np.float32)
    q = rng.randn(b, q_dim).astype(np.float32)
    num_boxes = np.array([R, R - 4])
    roi_mask = np.arange(R)[None, :] < num_boxes[:, None]
    v[~roi_mask] = 0.0
    w_l = rng.randn(b, num_ans).astype(np.float32)
    w_a = rng.randn(b, R, glimpse).astype(np.float32)

    def loss_fn(p):
        logits, alpha = mutan_apply(
            p, jnp.asarray(v), jnp.asarray(q), jnp.asarray(roi_mask),
            drop_rate=0.2, train=False, rngs=None, rank=rank,
        )
        return jnp.sum(logits * w_l) + jnp.sum(alpha * w_a)

    got = jax.device_get(jax.grad(loss_fn)(params))

    tm = TMuTAN(v_dim, q_dim, num_ans, rank, glimpse)
    tm.copy_from(params)
    tm.eval()
    logits, alpha = tm(_t(v), _t(q), torch.from_numpy(roi_mask))
    ((logits * _t(w_l)).sum() + (alpha * _t(w_a)).sum()).backward()

    def _block_grads(tb):
        return {
            name: _linear_grads(getattr(tb, name))
            for name in ("linear0", "linear1", "merge0", "merge1", "linear_out")
        }

    want = {
        "att_fusion": _block_grads(tm.att_fusion),
        "att_linear0": _fcnet_grads(tm.att_linear0),
        "att_linear1": _fcnet_grads(tm.att_linear1),
        "out_fusion": _block_grads(tm.out_fusion),
    }
    _assert_grad_trees_close(got, want)
