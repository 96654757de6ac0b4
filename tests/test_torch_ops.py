"""PyTorch port primitives against the JAX package at f32 on the CPU:
weight norm / FCNet, masked embedding, GRU, position matrix and embedding,
and the port's dropout scheme. Inputs come from np.random.RandomState;
parameters from the JAX initialisers, carried across by params.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.ops import embedding as jemb
from tf_vqa_regat_tpu.ops import gru as jgru
from tf_vqa_regat_tpu.ops import position as jpos
from tf_vqa_regat_tpu.ops import weight_norm as jwn
from tf_vqa_regat_tpu_torch import nn as tnn
from tf_vqa_regat_tpu_torch.ops import position as tpos
from tf_vqa_regat_tpu_torch.ops.embedding import Embedding
from tf_vqa_regat_tpu_torch.ops.gru import GRU
from tf_vqa_regat_tpu_torch.ops.weight_norm import FCNet
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GEN = torch.Generator().manual_seed(0)


def _carry(module, jax_params):
    load_jax_arrays(module, flatten_tree(jax.tree.map(np.asarray, jax_params)))
    return module.eval()


def _boxes(rng, b, R):
    xy = rng.rand(b, R, 2) * 500
    wh = rng.rand(b, R, 2) * 300 + 4
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize(
    "dims,act", [([32, 48], None), ([32, 48, 16], "relu"), ([24, 8], "relu")]
)
def test_fcnet_matches_jax(dims, act):
    p = jwn.fcnet_init(jax.random.PRNGKey(1), dims)
    x = np.random.RandomState(0).randn(3, 5, dims[0]).astype(np.float32)
    want = np.asarray(jwn.fcnet_apply(p, jnp.asarray(x), act))
    net = _carry(FCNet(dims, GEN, activation=act), p)
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_wn_kernel_is_scalar_g_over_frobenius_norm():
    p = jwn.fcnet_init(jax.random.PRNGKey(2), [16, 8])
    p["layers"][0]["g"] = jnp.float32(3.0)
    net = _carry(FCNet([16, 8], GEN, activation=None), p)
    k = net.layers[0].kernel().detach().numpy()
    np.testing.assert_allclose(np.linalg.norm(k), 3.0, rtol=1e-6)
    np.testing.assert_allclose(k, np.asarray(jwn.wn_kernel(p["layers"][0])), **TOL)


def test_embedding_zeroes_padding_rows():
    ntoken, dim = 12, 10
    p = jemb.embedding_init(jax.random.PRNGKey(3), ntoken + 1, dim)
    ids = np.random.RandomState(1).randint(0, ntoken + 1, size=(4, 14)).astype(np.int32)
    ids[:, -3:] = ntoken
    want = np.asarray(jemb.embedding_apply(p, jnp.asarray(ids), ntoken))
    emb = _carry(Embedding(ntoken + 1, dim, GEN), p)
    got = emb(torch.from_numpy(ids), ntoken).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[:, -3:].any()


def test_gru_matches_jax():
    p = jgru.gru_init(jax.random.PRNGKey(4), 24, 16)
    rng = np.random.RandomState(2)
    p["bias"] = jnp.asarray(rng.randn(2, 48).astype(np.float32) * 0.1)
    x = rng.randn(3, 14, 24).astype(np.float32)
    want = np.asarray(jgru.gru_apply(p, jnp.asarray(x)))
    got = _carry(GRU(24, 16, GEN), p)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_position_matrix_matches_jax():
    bb = _boxes(np.random.RandomState(3), 3, 12)
    want = np.asarray(jpos.position_matrix(jnp.asarray(bb), 5))
    got = tpos.position_matrix(torch.from_numpy(bb), 5).numpy()
    assert got.shape == (3, 12, 5, 4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("P", [16, 64])
def test_position_embedding_matches_jax(P):
    bb = _boxes(np.random.RandomState(4), 2, 10)
    pm = np.array(jpos.position_matrix(jnp.asarray(bb), 6))
    want = np.asarray(jpos.position_embedding(jnp.asarray(pm), P))
    got = tpos.position_embedding(torch.from_numpy(pm), P).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_dropout_uint8_scheme():
    x = torch.ones(200_000)
    assert tnn.dropout(x, 0.2, train=False) is x
    y = tnn.dropout(x, 0.2, train=True, generator=torch.Generator().manual_seed(5))
    t = round(0.2 * 256)  # 51: the quantised drop probability is t/256
    kept = y != 0
    np.testing.assert_allclose(y[kept].numpy(), 256.0 / (256 - t))
    assert abs(kept.float().mean().item() - (256 - t) / 256) < 0.005
    with pytest.raises(ValueError):
        tnn.dropout(x, 0.2, train=True)


def test_initialisers():
    g = torch.Generator().manual_seed(6)
    w = tnn.glorot_uniform((300, 100), g)
    assert w.abs().max() <= (6.0 / 400) ** 0.5
    o = tnn.orthogonal((16, 48), g)
    np.testing.assert_allclose((o @ o.T).numpy(), np.eye(16), atol=1e-5)
    n = tnn.normal((1000, 100), g)
    assert abs(n.std().item() - 0.05) < 0.002
