"""The port's spatial relation graph (ops/spatial_graph.py) against the JAX
package's `build_spatial_graph` under `jax.vmap` (as models/regat.py applies
it) and `broadcast_adj_labels`, on the CPU: exact equality of every label.

Boxes come from the synthetic split's box generator, with nested pairs
(labels 1 and 2), near-duplicates (label 3) and padded slots: a batch's last
example has no box at all, so its normalised row 0 is zero and the image size
divides by zero; its labels must still be 0, never NaN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.ops.spatial_graph import broadcast_adj_labels as jax_broadcast
from tf_vqa_regat_tpu.ops.spatial_graph import build_spatial_graph as jax_build
from tf_vqa_regat_tpu_torch.data.synthetic import _rand_boxes
from tf_vqa_regat_tpu_torch.ops.spatial_graph import (
    broadcast_adj_labels,
    build_spatial_graph,
)

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

B, R = 6, 36


def _boxes(seed):
    """([B, R, 4], [B, R, 6]) f32: 1..R boxes per example, zero-padded; the
    last example fully padded."""
    rng = np.random.RandomState(seed)
    bb = np.zeros((B, R, 4), np.float32)
    norm = np.zeros((B, R, 6), np.float32)
    for i in range(B - 1):
        c = rng.randint(4 if i == 0 else 1, R + 1)
        bb[i, :c], norm[i, :c] = _rand_boxes(rng, c)
    bb[0, 1] = bb[0, 0] + np.array([-20, -20, 20, 20], np.float32)  # 1 covers 0
    bb[0, 2] = bb[0, 0] + np.array([1, 0, 1, 0], np.float32)  # IoU >= 0.5 with 0
    bb[0, 3] = bb[0, 1] + np.array([-5, -5, 5, 5], np.float32)  # 3 covers 1
    return bb, norm


@pytest.mark.parametrize("seed", range(4))
def test_labels_equal_jax(seed):
    bb, norm = _boxes(seed)
    want = np.asarray(jax.vmap(jax_build)(jnp.asarray(bb), jnp.asarray(norm)))
    got = build_spatial_graph(torch.from_numpy(bb), torch.from_numpy(norm))
    assert got.dtype == torch.int32 and got.shape == (B, R, R)
    np.testing.assert_array_equal(got.numpy(), want)
    got = got.numpy()
    assert not got[-1].any()  # the padded example: no edges, no NaN
    assert {1, 2, 3, 12} <= set(np.unique(got[0]))
    assert set(np.unique(got)) <= set(range(13))
    n_valid = (bb.sum(-1) != 0).sum(-1)
    assert (np.diagonal(got, axis1=1, axis2=2) == 12).sum() == n_valid.sum()


@pytest.mark.parametrize("label_num", [11, 15])
def test_one_hot_equals_jax(label_num):
    adj = np.random.RandomState(label_num).randint(0, 16, (3, R, R)).astype(np.int32)
    got = broadcast_adj_labels(torch.from_numpy(adj), label_num)
    want = np.asarray(jax_broadcast(jnp.asarray(adj), label_num))
    assert got.dtype == torch.float32 and got.shape == (3, R, R, label_num)
    np.testing.assert_array_equal(got.numpy(), want)
    # label 0 and labels past label_num (the self loop 12 at 11) give no edge
    assert not got.numpy()[(adj == 0) | (adj > label_num)].any()
