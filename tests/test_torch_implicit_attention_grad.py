"""The gradient of the port's fused implicit attention (B1): the
`ImplicitAttention` autograd Function, whose backward transcribes
`_fused_v3_bwd`, against `jax.grad` through the JAX package's kernel in
interpret mode (whose VJP is `_fused_v3_bwd`), and against torch autograd
of the port's plain version. On the CPU the Function's forward is the plain
version with the train variant's extra output `pwr`.

Shapes: b=4, R=16, H=4, dh=o=24, n=10, P=64, with random key masks, one
fully masked example, one row whose other heads underflow, and a uint8
keep-mask fed to both sides.

Tolerances: atol/rtol 1e-5 on dq, dk and dvw, which are sums of a few dozen
f32 products. dW_pos and db_pos sum dpwr = daff / pwr over every (row, key),
and 1/pwr reaches 1e6 where pwr sits just above its 1e-6 floor, so they are
held to 1e-5 of their largest magnitude instead.

Conditioning: log(pwr) magnifies any error of pwr by 1/pwr, so the `masks`
case asserts that no pre-relu pos-FC value lies in (0, 1e-3]. And the first
call of torch's CPU sine in a process has been seen to return values ~1.5e-4
off at some arguments (about one process in eight; a second call on the same
tensor is exact), which the log turns into differences of ~5e-2 in the
gradients. So the module runs the port's plain version once before any
comparison.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.ops import weight_norm as jwn
from tf_vqa_regat_tpu.ops.graph_attention import graph_attention_init
from tf_vqa_regat_tpu.ops.pallas import implicit_attention as jia
from tf_vqa_regat_tpu.ops.position import position_matrix
from tf_vqa_regat_tpu_torch.ops.kernels.implicit_attention import (
    KERNEL,
    fused_implicit_graph_attention,
    implicit_attention_plain,
)

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

B, R, H, DH, N, P = 4, 16, 4, 24, 10, 64
DIFF = ("q", "k", "vw", "w_pos", "b_pos")
ARGS = ("q", "k", "vw", "pos_mat", "w_pos", "b_pos", "key_mask")
TOL = dict(atol=1e-5, rtol=1e-5)
POS_RTOL = 1e-5  # of max |dW_pos| (|db_pos|)


def _inputs(seed, underflow=False):
    rng = np.random.RandomState(seed)
    params = graph_attention_init(jax.random.PRNGKey(seed), H * DH, H, pos_emb_dim=P)
    layer = params["pair_pos_fc"]["layers"][0]
    xy = rng.rand(B, R, 2) * 500
    wh = rng.rand(B, R, 2) * 300 + 4
    bb = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    num_boxes = rng.randint(1, R + 1, size=B)
    num_boxes[-1] = 0  # a padded slot: every key masked
    x = dict(
        q=rng.randn(B, R, H, DH).astype(np.float32),
        k=rng.randn(B, N, H, DH).astype(np.float32),
        vw=rng.randn(B, N, H, DH).astype(np.float32),
        pos_mat=np.array(position_matrix(jnp.asarray(bb), N)),
        w_pos=np.array(jwn.wn_kernel(layer)),
        b_pos=(rng.randn(H) * 0.5).astype(np.float32),
        key_mask=np.arange(N)[None, :] < num_boxes[:, None],
        g=rng.randn(B, R, H, DH).astype(np.float32),
    )
    if underflow:
        # row 7 of example 0: head 0 outscores the others by ~300, so their
        # weights underflow to exactly zero, and so do their gradients
        x["k"][0, :, 0, :] = 8.0
        x["q"][0, 7, 0, :] = 8.0
    return x


@pytest.fixture(scope="module", autouse=True)
def _warm_torch_cpu_kernels():
    """One call of the plain version (sine, cosine, log, exp, einsums) before
    the compared ones: see the module docstring."""
    x = _inputs(5)
    implicit_attention_plain(*(torch.from_numpy(x[n]) for n in ARGS))


def _pre_relu_pos_fc(x):
    """The pos-FC output before the relu, [b, R, H, n], in float64 from the
    JAX kernel's own sinusoid constants."""
    pm = np.transpose(x["pos_mat"], (0, 1, 3, 2)).reshape(B, R, 4 * N).astype(np.float64)
    pe_pre = pm @ jia._rep_matrix(N, P)
    pe = np.where(jia._is_cos_row(N, P)[0] > 0, np.cos(pe_pre), np.sin(pe_pre))
    return np.einsum("brmp,ph->brhm", pe.reshape(B, R, N, P), x["w_pos"]) + x["b_pos"][:, None]


@functools.partial(jax.jit, static_argnums=(0,))
def _jax_grad_fn(drop_rate, q, k, vw, w_pos, b_pos, pos_mat, key_mask, g, dropmask):
    def loss(q, k, vw, w_pos, b_pos):
        out = jia.fused_implicit_graph_attention(
            q, k, vw, pos_mat, w_pos, b_pos, key_mask, drop_rate, dropmask,
            interpret=True,
        )
        return jnp.sum(out * g)

    return jax.grad(loss, argnums=tuple(range(5)))(q, k, vw, w_pos, b_pos)


def _jax_grads(x, drop_rate, dropmask):
    args = [x[n] for n in DIFF + ("pos_mat", "key_mask", "g")] + [dropmask]
    grads = _jax_grad_fn(drop_rate, *(None if a is None else jnp.asarray(a) for a in args))
    return dict(zip(DIFF, map(np.asarray, grads)))


def _torch_grads(fn, x, drop_rate, dropmask):
    t = {n: torch.tensor(x[n], requires_grad=n in DIFF) for n in ARGS}
    mask = None if dropmask is None else torch.from_numpy(dropmask)
    out = fn(*(t[n] for n in ARGS), drop_rate, mask)
    (out * torch.from_numpy(x["g"])).sum().backward()
    return {n: t[n].grad.numpy() for n in DIFF}


def _assert_grads_close(got, want):
    for n in ("q", "k", "vw"):
        np.testing.assert_allclose(got[n], want[n], **TOL, err_msg=n)
    for n in ("w_pos", "b_pos"):
        scale = np.abs(want[n]).max()
        assert np.abs(got[n] - want[n]).max() <= POS_RTOL * scale, n


@pytest.mark.parametrize(
    "seed, underflow, drop", [(0, False, False), (1, True, False), (2, False, True)],
    ids=["masks", "underflow", "dropmask"],
)
def test_function_grads_match_jax_and_plain_autograd(seed, underflow, drop):
    x = _inputs(seed, underflow)
    if seed == 0:  # the `masks` case: no pos weight just above log's floor
        pre = _pre_relu_pos_fc(x)
        assert not ((pre > 0) & (pre <= 1e-3)).any()
    drop_rate, dropmask = 0.0, None
    if drop:
        drop_rate = 0.2
        bits = np.random.RandomState(seed + 100).randint(0, 256, (B, R, N, P))
        dropmask = (bits >= 51).astype(np.uint8)
    got = _torch_grads(fused_implicit_graph_attention, x, drop_rate, dropmask)
    for n in DIFF:
        assert np.isfinite(got[n]).all(), n
    _assert_grads_close(got, _jax_grads(x, drop_rate, dropmask))
    _assert_grads_close(got, _torch_grads(implicit_attention_plain, x, drop_rate, dropmask))
    if underflow:
        # the underflowing heads of row 7 get no gradient
        assert not got["q"][0, 7, 1:].any()
    # the padded example's rows attend uniformly; their gradients stay finite
    assert np.abs(got["q"][-1]).max() > 0.0


def test_pwr_is_the_post_relu_pos_weights():
    """The train variant's extra output, against relu(pos-FC) built from the
    JAX kernel's own sinusoid constants (`_rep_matrix`, `_is_cos_row`)."""
    x = _inputs(3)
    t = {n: torch.from_numpy(x[n]) for n in ARGS}
    out, pwr = implicit_attention_plain(*(t[n] for n in ARGS), save_pwr=True)
    pw = _pre_relu_pos_fc(x)
    np.testing.assert_allclose(pwr.numpy(), np.maximum(pw, 0.0), atol=1e-5, rtol=1e-5)
    assert (pwr >= 0).all() and (pwr == 0).any()
    np.testing.assert_array_equal(
        out.numpy(), implicit_attention_plain(*(t[n] for n in ARGS)).numpy()
    )


def test_no_call_drops_a_gradient():
    """The launch path refuses tensors that need a gradient; a gradient
    w.r.t. the position matrix, or a dropout rate without its mask, raises."""
    x = {n: torch.from_numpy(v) for n, v in _inputs(4).items()}
    args = [x[n] for n in ARGS]
    q = x["q"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="drop a gradient"):
        KERNEL(q, *args[1:], 0.0, None)
    pos = x["pos_mat"].clone().requires_grad_()
    with pytest.raises(ValueError, match="pos_mat"):
        fused_implicit_graph_attention(*args[:3], pos, *args[4:])
    with pytest.raises(ValueError, match="keep-mask"):
        fused_implicit_graph_attention(q, *args[1:], 0.2, None)
    out = fused_implicit_graph_attention(q, *args[1:])
    assert out.grad_fn is not None and "ImplicitAttention" in type(out.grad_fn).__name__
