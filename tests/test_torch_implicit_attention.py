"""The port's fused implicit attention (B1) on the CPU, where it runs its plain
PyTorch version, against the JAX package: the Pallas kernel in interpret mode
(`fused_implicit_graph_attention(..., interpret=True)`) and the layer's jnp
path (`graph_attention_apply(impl="jnp")`); and, without a card, the
wrapper's hold on a sliced key mask (its row stride, no copy).

Shapes: b=4, R=16, H=4, dh=o=24, n=10, P=64. Tolerances: 1e-5 against the
interpret kernel, which computes the same function in the same f32 steps.
1e-3 against the jnp path: that path rounds the sinusoid argument twice
(100*pos, then the frequency) where the kernel rounds it once, and
log(max(relu(x), 1e-6)) magnifies the difference wherever the pos-FC output
x lies just above 1e-6. The JAX package's own kernel is 4.7e-4 from the jnp
path on the layer test's inputs; the port is within 2.4e-5 of that kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.ops import weight_norm as jwn
from tf_vqa_regat_tpu.ops.graph_attention import (
    _grouped_kernel,
    graph_attention_apply,
    graph_attention_init,
)
from tf_vqa_regat_tpu.ops.pallas import implicit_attention as jia
from tf_vqa_regat_tpu.ops.position import position_matrix
from tf_vqa_regat_tpu_torch.ops.graph_attention import GraphSelfAttention
from tf_vqa_regat_tpu_torch.ops.kernels import build
from tf_vqa_regat_tpu_torch.ops.kernels import implicit_attention as ia
from tf_vqa_regat_tpu_torch.ops.kernels.implicit_attention import (
    fused_implicit_graph_attention,
)
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

B, R, H, DH, N, P = 4, 16, 4, 24, 10, 64
D = H * DH
KERNEL_TOL = dict(atol=1e-5, rtol=1e-5)
JNP_TOL = dict(atol=1e-3, rtol=1e-3)


def _boxes(rng):
    xy = rng.rand(B, R, 2) * 500
    wh = rng.rand(B, R, 2) * 300 + 4
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _inputs(seed):
    """Kernel inputs as numpy: key masks from random box counts, the last
    example fully masked (a padded serve slot)."""
    rng = np.random.RandomState(seed)
    params = graph_attention_init(jax.random.PRNGKey(seed), D, H, pos_emb_dim=P)
    layer = params["pair_pos_fc"]["layers"][0]
    layer["b"] = jnp.asarray(rng.randn(H).astype(np.float32) * 0.5)
    num_boxes = rng.randint(1, R + 1, size=B)
    num_boxes[-1] = 0
    return dict(
        q=rng.randn(B, R, H, DH).astype(np.float32),
        k=rng.randn(B, N, H, DH).astype(np.float32),
        vw=rng.randn(B, N, H, DH).astype(np.float32),
        pos_mat=np.array(position_matrix(jnp.asarray(_boxes(rng)), N)),
        w_pos=np.array(jwn.wn_kernel(layer)),
        b_pos=np.array(layer["b"]),
        key_mask=np.arange(N)[None, :] < num_boxes[:, None],
    )


def _both(x, drop_rate=0.0, dropmask=None):
    args = [x[k] for k in ("q", "k", "vw", "pos_mat", "w_pos", "b_pos", "key_mask")]
    want = jia.fused_implicit_graph_attention(
        *map(jnp.asarray, args), drop_rate,
        None if dropmask is None else jnp.asarray(dropmask), interpret=True,
    )
    got = fused_implicit_graph_attention(
        *map(torch.from_numpy, args), drop_rate,
        None if dropmask is None else torch.from_numpy(dropmask),
    )
    return got.numpy(), np.asarray(want)


def test_matches_interpret_kernel_with_masks():
    x = _inputs(0)
    got, want = _both(x)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    # the fully masked example attends uniformly to all n keys
    np.testing.assert_allclose(got[-1], np.broadcast_to(x["vw"][-1].mean(0), got[-1].shape),
                               atol=1e-5)


def test_underflowing_heads_give_zeros():
    """One row where head 0's affinities exceed the others' by ~1250: the
    other heads underflow against the row max over all heads and get
    all-zero weights (a per-head softmax would give uniform ones)."""
    x = _inputs(1)
    x["k"][0, :, 0, :] = 16.0
    x["q"][0, 3, 0, :] = 16.0
    got, want = _both(x)
    assert not got[0, 3, 1:].any()
    assert not want[0, 3, 1:].any()
    assert np.abs(got[0, 3, 0]).max() > 0
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


def test_dropmask_matches_interpret_kernel():
    x = _inputs(2)
    dropmask = (np.random.RandomState(7).rand(B, R, N, P) > 0.3).astype(np.uint8)
    got, want = _both(x, 0.3, dropmask)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    plain, _ = _both(x)
    assert np.abs(got - plain).max() > 1e-3  # the mask took effect


def _layer_setup(seed):
    rng = np.random.RandomState(seed)
    params = graph_attention_init(jax.random.PRNGKey(seed), D, H, pos_emb_dim=P)
    roi = rng.randn(B, R, D).astype(np.float32)
    pos_mat = np.array(position_matrix(jnp.asarray(_boxes(rng)), N))
    num_boxes = rng.randint(1, R + 1, size=B)
    num_boxes[-1] = 0
    key_mask = np.arange(N)[None, :] < num_boxes[:, None]
    layer = GraphSelfAttention(D, H, P, torch.Generator().manual_seed(0))
    load_jax_arrays(layer, flatten_tree(jax.tree.map(np.asarray, params)))
    got = layer(*map(torch.from_numpy, (roi, pos_mat, key_mask))).detach().numpy()
    return params, (jnp.asarray(roi), jnp.asarray(pos_mat), jnp.asarray(key_mask)), got


@pytest.mark.parametrize("impl,tol", [("pallas", KERNEL_TOL), ("jnp", JNP_TOL)])
def test_layer_matches_graph_attention_apply(impl, tol):
    params, (roi, pos_mat, key_mask), got = _layer_setup(3)
    want = graph_attention_apply(
        params, roi, nongt_dim=N, num_heads=H, pos_mat=pos_mat,
        key_mask=key_mask, impl=impl,
    )
    np.testing.assert_allclose(got, np.asarray(want), **tol)


def test_layer_projects_v_with_the_grouped_kernel():
    params, (roi, _, _), _ = _layer_setup(4)
    layer = GraphSelfAttention(D, H, P, torch.Generator().manual_seed(0))
    load_jax_arrays(layer, flatten_tree(jax.tree.map(np.asarray, params)))
    np.testing.assert_allclose(
        layer.out.kernel().detach().numpy(), np.asarray(_grouped_kernel(params["out"])),
        **KERNEL_TOL,
    )


def test_no_fallback_off_the_cpu():
    """A tensor on a device with no kernel raises; it is never moved to the
    CPU version."""
    x = {k: torch.from_numpy(v).to("meta") for k, v in _inputs(5).items()}
    with pytest.raises(ValueError, match="no implicit attention kernel"):
        fused_implicit_graph_attention(
            x["q"], x["k"], x["vw"], x["pos_mat"], x["w_pos"], x["b_pos"], x["key_mask"]
        )


def test_a_sliced_key_mask_is_read_through_its_row_stride(monkeypatch):
    """The model passes roi_mask[:, :n], a slice of a wider mask: the launch
    takes its row stride and copies nothing; a mask whose keys are not
    contiguous is refused before any build."""

    def built(*_):
        raise RuntimeError("built")

    monkeypatch.setattr(build, "build", built)
    monkeypatch.setattr(build, "load", built)
    monkeypatch.setattr(ia.LIB, "_handle", None)
    b, R, n, H, P = 2, 3, 20, 16, 64
    args = (torch.zeros(b, R, H, 64), torch.zeros(b, n, H, 64), torch.zeros(b, n, H, 64),
            torch.zeros(b, R, n, 4), torch.zeros(P, H), torch.zeros(H))
    wide = torch.ones(b, 100, dtype=torch.bool)
    kernel = ia._Kernel()
    with torch.no_grad(), pytest.raises(RuntimeError, match="built"):
        kernel(*args, wide[:, :n], 0.0, None)
    assert [a.sm for a in kernel._launch_args.values()] == [100]
    with torch.no_grad(), pytest.raises(ValueError, match="keys must be contiguous"):
        kernel(*args, wide[:, ::5], 0.0, None)
