"""The port's fused masked graph attention (B2) against the JAX package's
kernel in interpret mode, on the CPU:

- `graph_attention_plain` (v2, the global-max / eps softmax) against
  `fused_graph_attention(..., interpret=True)`, which runs `_fwd_kernel_v2`;
- the per-head mode (v1) against the same call with the JAX module's
  `_KERNEL_VERSION` set to 1 for the test (`_fwd_kernel`, the per-head loop),
  and against a jnp oracle built on `jax.nn.softmax`;
- the `GraphAttention` Function's gradients (dq, dk, dvw, dbias) against
  `jax.grad` through `_fused`'s custom VJP (`_fused_bwd`) in both modes, and
  against torch autograd of the plain version;
- without a card, the wrapper around its launches: the v2 backward needs
  the forward's row maxima, and the forward under grad keeps them (v2
  only), while a launch without grad keeps none.

Inputs are built as the model builds them: edge labels and a label bias,
non-edges at -9e15, then the key mask at -9e15 (b=4, R=16, H=4, dh=o=24,
n=10). They hold a query row with an empty adjacency row (uniform weights
over the valid keys), a fully padded example (uniform over all keys), and a
row whose heads 1.. have no edge while head 0 has some: with a per-head bias
those heads underflow against head 0's max (all-zero weights in v2, uniform
over the valid keys in v1). The bias comes shared across heads [b, R, 1, n],
as the model passes it, and per head [b, R, H, n].

Tolerance: atol/rtol 1e-5 (f32 sums of at most dh products in another
order).
"""

import collections
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.ops.pallas import graph_attention as jga
from tf_vqa_regat_tpu_torch.ops.kernels import build
from tf_vqa_regat_tpu_torch.ops.kernels import graph_attention as ga
from tf_vqa_regat_tpu_torch.ops.kernels.graph_attention import (
    KERNEL,
    GraphAttention,
    fused_graph_attention,
    graph_attention_plain,
)

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

B, R, H, DH, N = 4, 16, 4, 24, 10
NEG = -9e15
TOL = dict(atol=1e-5, rtol=1e-5)
NAMES = ("q", "k", "vw", "bias")
EMPTY_ROW = (0, 3)  # (example, row): no edge at all
SPLIT_ROW = (1, 5)  # heads 1.. have no edge (per-head bias only)


def _inputs(seed, per_head_bias):
    rng = np.random.RandomState(seed)
    num_boxes = np.array([N + 3, 7, 4, 0])  # the last example is padded
    key_ok = np.arange(N)[None, :] < num_boxes[:, None]  # [B, N]
    adj = rng.rand(B, R, N) < 0.4
    adj[EMPTY_ROW] = False
    adj[-1] = False  # a padded slot has no edges (spatial labels 0, adj zeroed)
    shape = (B, R, H, N) if per_head_bias else (B, R, 1, N)
    label_bias = (rng.randn(*shape) * 0.5).astype(np.float32)
    edge = np.broadcast_to(adj[:, :, None, :], shape).copy()
    if per_head_bias:
        edge[SPLIT_ROW[0], SPLIT_ROW[1], 1:] = False
        edge[SPLIT_ROW[0], SPLIT_ROW[1], 0, 0] = True
    bias = np.where(edge, label_bias, np.float32(NEG)).astype(np.float32)
    bias = (bias + np.where(key_ok[:, None, None, :], 0.0, NEG)).astype(np.float32)
    return dict(
        q=rng.randn(B, R, H, DH).astype(np.float32),
        k=rng.randn(B, N, H, DH).astype(np.float32),
        vw=rng.randn(B, N, H, DH).astype(np.float32),
        bias=bias,
        g=rng.randn(B, R, H, DH).astype(np.float32),
        num_boxes=num_boxes,
    )


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_out_and_grads(version, q, k, vw, bias, g):
    """(out, (dq, dk, dvw, dbias)) of the JAX kernel in interpret mode; the
    version (1 or 2) is the one `_KERNEL_VERSION` holds while this traces."""
    def loss(q, k, vw, bias):
        out = jga.fused_graph_attention(q, k, vw, bias, interpret=True)
        return jnp.sum(out * g), out

    grads, out = jax.grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(q, k, vw, bias)
    return out, grads


def _jax(x, per_head, monkeypatch):
    version = 1 if per_head else 2
    monkeypatch.setattr(jga, "_KERNEL_VERSION", version)
    out, grads = _jax_out_and_grads(version, *(jnp.asarray(x[n]) for n in NAMES + ("g",)))
    return np.asarray(out), dict(zip(NAMES, map(np.asarray, grads)))


def _softmax_oracle(x):
    """v1's function in jnp: a per-head jax.nn.softmax."""
    aff = jnp.einsum("brhd,bnhd->brhn", x["q"], x["k"]) * (1.0 / np.sqrt(DH)) + x["bias"]
    return np.asarray(jnp.einsum("brhn,bnho->brho", jax.nn.softmax(aff, axis=-1), x["vw"]))


def _torch(fn, x, per_head):
    t = {n: torch.tensor(x[n], requires_grad=True) for n in NAMES}
    out = fn(*(t[n] for n in NAMES), per_head)
    (out * torch.from_numpy(x["g"])).sum().backward()
    return out.detach().numpy(), {n: t[n].grad.numpy() for n in NAMES}


CASES = [(0, False, False), (1, True, False), (2, False, True), (3, True, True)]
IDS = ["v2-shared-bias", "v2-per-head-bias", "v1-shared-bias", "v1-per-head-bias"]


@pytest.mark.parametrize("seed, per_head_bias, per_head", CASES, ids=IDS)
def test_plain_matches_the_interpret_kernel(seed, per_head_bias, per_head, monkeypatch):
    x = _inputs(seed, per_head_bias)
    t = {n: torch.from_numpy(x[n]) for n in NAMES}
    got = graph_attention_plain(*(t[n] for n in NAMES), per_head).numpy()
    want, _ = _jax(x, per_head, monkeypatch)
    assert got.shape == (B, R, H, DH) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    if per_head:
        np.testing.assert_allclose(got, _softmax_oracle(x), **TOL)
    with torch.no_grad():  # on a CPU tensor the wrapper runs the plain version
        np.testing.assert_array_equal(fused_graph_attention(*(t[n] for n in NAMES), per_head), got)

    # degenerate rows: an empty adjacency row and the padded example attend
    # uniformly over their valid keys (all n keys when none is valid)
    e, r = EMPTY_ROW
    np.testing.assert_allclose(got[e, r], x["vw"][e, : x["num_boxes"][e]].mean(0), **TOL)
    np.testing.assert_allclose(got[-1], np.broadcast_to(x["vw"][-1].mean(0), got[-1].shape), **TOL)
    if per_head_bias:
        e, r = SPLIT_ROW
        if per_head:  # own softmax per head: uniform over the valid keys
            np.testing.assert_allclose(got[e, r, 1:], x["vw"][e, : x["num_boxes"][e], 1:].mean(0), **TOL)
        else:  # the other heads underflow against head 0's max
            assert not got[e, r, 1:].any() and got[e, r, 0].any()


@pytest.mark.parametrize("seed, per_head_bias, per_head", CASES, ids=IDS)
def test_function_grads_match_jax_and_plain_autograd(seed, per_head_bias, per_head, monkeypatch):
    x = _inputs(10 + seed, per_head_bias)
    out, got = _torch(fused_graph_attention, x, per_head)
    want_out, want = _jax(x, per_head, monkeypatch)
    _, plain = _torch(graph_attention_plain, x, per_head)
    np.testing.assert_allclose(out, want_out, **TOL)
    for n in NAMES:
        assert got[n].shape == x[n].shape and np.isfinite(got[n]).all(), n
        np.testing.assert_allclose(got[n], want[n], **TOL, err_msg=n)
        np.testing.assert_allclose(got[n], plain[n], **TOL, err_msg=n)
    if per_head_bias and not per_head:
        e, r = SPLIT_ROW
        assert not got["q"][e, r, 1:].any()  # zero weights carry no gradient


def test_no_call_drops_a_gradient():
    """The launch path refuses tensors that need a gradient; a call that
    needs one goes through the Function."""
    x = {n: torch.from_numpy(v) for n, v in _inputs(4, False).items() if n in NAMES}
    bias = x["bias"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="drop a gradient"):
        KERNEL(x["q"], x["k"], x["vw"], bias)
    out = fused_graph_attention(x["q"], x["k"], x["vw"], bias)
    assert type(out.grad_fn).__name__ == GraphAttention.__name__ + "Backward"
    with torch.no_grad():
        assert fused_graph_attention(x["q"], x["k"], x["vw"], bias).grad_fn is None


def test_v2_backward_needs_the_row_maxima(monkeypatch):
    def no_build(*_):
        raise AssertionError("the kernel was built for a shape it does not take")

    monkeypatch.setattr(build, "build", no_build)
    monkeypatch.setattr(build, "load", no_build)
    b, R, H, n, d = 2, 3, 4, 5, 8
    args = (torch.zeros(b, R, H, d), torch.zeros(b, R, H, d), torch.zeros(b, n, H, d),
            torch.zeros(b, n, H, d), torch.zeros(b, R, 1, n), None)
    with pytest.raises(ValueError, match="row maxima"):
        ga._Kernel().backward(*args)


def test_forward_under_grad_keeps_the_row_maxima(monkeypatch):
    """The Function's forward on the card asks the launch for v2's row
    maxima and saves them for the backward; a launch without grad keeps
    none (the eval, serve and predict path is the one it was)."""
    calls = []

    def fwd(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(ga.LIB, "load", lambda: types.SimpleNamespace(
        regat_graph_attention_fwd=fwd, regat_graph_attention_set_smem=lambda _s: 0))
    monkeypatch.setattr(ga.LIB, "_smem", {})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: None)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda _index: 0, raising=False)
    monkeypatch.setattr(ga, "COUNTS", collections.Counter())  # leave the registry's as it was
    kernel = ga._Kernel()
    b, R, H, n, d = 2, 3, 4, 5, 8
    x = (torch.zeros(b, R, H, d), torch.zeros(b, n, H, d), torch.zeros(b, n, H, d),
         torch.zeros(b, R, 1, n))
    with torch.no_grad():
        assert kernel(*x).shape == (b, R, H, d)
        out, rowmax = kernel(*x, save_max=True)
        assert rowmax.shape == (b, R)
        assert kernel(*x, True, save_max=True)[1] is None  # v1: its own max per head
    assert [c[5] is None for c in calls] == [True, False, True]
    assert [c[7] for c in calls] == [0, 0, 1]
