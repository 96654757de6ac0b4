"""The port's whole model (implicit relations; BUTD, BAN and MuTAN fusion,
MuTAN at rank 3) against the JAX package's `apply_regat(train=False)` on
the CPU, with the JAX parameters carried across: with `impl="pallas"` (B1
in interpret mode, one launch per direction) and `impl="jnp"` (both
directions folded into one 2H-head jnp computation).

Tolerance: atol/rtol 1e-4 on the logits, looser than the 1e-5 of the single
ops because sums run in another order through the stacked f32 matmuls
(GRU, relation, fusion, classifier). The argmax must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config
from tf_vqa_regat_tpu.models.regat import apply_regat, init_regat
from tf_vqa_regat_tpu_torch import config as tconfig
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CFG = Config(
    num_hid=64, relation_dim=96, num_heads=4, nongt_dim=10, imp_pos_emb_dim=64,
    fusion="butd", relation_type="implicit", adaptive=True, num_rois=16,
    residual_connection=True, mutan_rank=3,
)


def _port_cfg(cfg):
    return tconfig.Config(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tconfig.Config)}
    )


PORT_CFG = _port_cfg(CFG)
NTOKEN, V_DIM, NUM_ANS, B = 25, 32, 11, 6
TOL = dict(atol=1e-4, rtol=1e-4)


def _batch(seed):
    """Random features and boxes; box counts 1-16, with one padded slot
    (num_boxes 0) as the serve engine makes; questions padded after 9 tokens."""
    rng = np.random.RandomState(seed)
    R = CFG.resolved_num_rois()
    num_boxes = rng.randint(1, R + 1, size=B).astype(np.int32)
    num_boxes[2] = 0
    roi_ok = (np.arange(R)[None, :] < num_boxes[:, None])[..., None]
    xy = rng.rand(B, R, 2) * 450
    wh = rng.rand(B, R, 2) * 190 + 4
    question = rng.randint(0, NTOKEN, size=(B, 14)).astype(np.int32)
    question[:, 9:] = NTOKEN
    return {
        "features": (rng.randn(B, R, V_DIM) * roi_ok).astype(np.float32),
        "bb": (np.concatenate([xy, xy + wh], -1) * roi_ok).astype(np.float32),
        "question": question,
        "num_boxes": num_boxes,
    }


@pytest.fixture(scope="module", params=["butd", "ban", "mutan"])
def models(request):
    cfg = dataclasses.replace(CFG, fusion=request.param)
    params = init_regat(jax.random.PRNGKey(0), cfg, NTOKEN, V_DIM, NUM_ANS)
    port = ReGAT(_port_cfg(cfg), NTOKEN, V_DIM, NUM_ANS, torch.Generator().manual_seed(0))
    load_jax_arrays(port, flatten_tree(jax.tree.map(np.asarray, params)))
    return cfg, params, port.eval()


@pytest.mark.parametrize("impl", ["pallas", "jnp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_logits_match_apply_regat(models, impl, seed):
    cfg, params, port = models
    batch = _batch(seed)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["norm_bb"] = jnp.zeros(batch["bb"].shape[:2] + (6,), jnp.float32)
    jbatch["valid"] = jnp.asarray(batch["num_boxes"] > 0)
    want = np.asarray(apply_regat(params, cfg, jbatch, NTOKEN, train=False, impl=impl))
    with torch.inference_mode():
        got = port({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert got.shape == (B, NUM_ANS) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_unported_families_and_training_raise():
    with pytest.raises(ValueError, match="unknown fusion"):
        ReGAT(PORT_CFG.replace(fusion="mlb"), NTOKEN, V_DIM, NUM_ANS)
    with pytest.raises(ValueError, match="unknown relation_type"):
        ReGAT(PORT_CFG.replace(relation_type="geometric"), NTOKEN, V_DIM, NUM_ANS)
    # MuTAN scores the answers itself: no classifier parameters
    mutan = ReGAT(PORT_CFG.replace(fusion="mutan"), NTOKEN, V_DIM, NUM_ANS)
    assert mutan.classifier is None
    assert not any(n.startswith("classifier.") for n, _ in mutan.named_parameters())
    model = ReGAT(PORT_CFG, NTOKEN, V_DIM, NUM_ANS)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    # a train forward with dropout on draws its masks from the step's
    # generator, and raises without one
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        model.train()(batch)
