"""The port's training pieces against the JAX package's, on the CPU: the loss
and the VQA score (train/loss.py), the LR table (make_lr_schedule), the
clip -> Adamax -> freeze chain (make_optimizer, optax), the frozen leaves
(trainable_mask), and the device store's epoch order and batch gather
(data/device_store.py), on the port's synthetic split and the JAX fixture
of the same seed.

Tolerances: 1e-6 relative on the loss, the learning rates and the
optimizer's moments and parameters (f32, the same operations in another
order); exact equality on indices, tokens, targets and masks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tf_vqa_regat_tpu.config import Config
from tf_vqa_regat_tpu.data.device_store import DeviceStore as JaxDeviceStore
from tf_vqa_regat_tpu.data.device_store import gather_batch as jax_gather_batch
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
from tf_vqa_regat_tpu.train import loss as jloss
from tf_vqa_regat_tpu.train.optim import make_lr_schedule as jax_lr_schedule
from tf_vqa_regat_tpu.train.optim import make_optimizer
from tf_vqa_regat_tpu_torch import config as tconfig
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch, pack_soft_targets
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.params import flatten_tree
from tf_vqa_regat_tpu_torch.train import loss as tloss
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

RTOL = 1e-6


def test_loss_and_score_match_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(8, 30) * 4).astype(np.float32)
    targets = (rng.rand(8, 30) * (rng.rand(8, 30) < 0.2)).astype(np.float32)
    for valid in (rng.rand(8) < 0.6, np.zeros(8, bool)):
        j = [jnp.asarray(a) for a in (logits, targets, valid)]
        t = [torch.from_numpy(a) for a in (logits, targets, valid)]
        np.testing.assert_allclose(
            tloss.bce_with_logits_sum(*t).item(), float(jloss.bce_with_logits_sum(*j)),
            rtol=RTOL,
        )
        assert tloss.vqa_score_sum(*t).item() == pytest.approx(
            float(jloss.vqa_score_sum(*j)), rel=RTOL
        )


def test_lr_table_matches_jax():
    """12 epochs of 3 steps at lr_decay_step 2: warmup, then decays at
    epochs 5, 7, 9 and 11."""
    port = make_lr_schedule(1e-3, 3, 0.25, 2)
    ref = jax_lr_schedule(1e-3, 3, 0.25, 2)
    got = [port(s) for s in range(36)]
    want = [float(ref(jnp.asarray(s))) for s in range(36)]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert got[14] == pytest.approx(1.4e-3) and got[15] == pytest.approx(1.4e-3 * 0.25)


class _Three(nn.Module):
    def __init__(self, shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.zeros(shape)))


@pytest.mark.parametrize("steps", [1, 3])
def test_optimizer_matches_the_optax_chain(steps):
    """Per-tensor clip (one tensor over the clip norm, one under), Adamax,
    and a frozen leaf whose moments advance while it stays put; the LR
    changes every step (one step per epoch)."""
    rng = np.random.RandomState(steps)
    shapes = {"a": (5, 3), "b": (7,), "frozen": (4, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    mask = {"a": True, "b": True, "frozen": False}
    opt = make_optimizer(1e-2, 0.25, 1, 0.5, 1, mask)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jparams)
    model = _Three(shapes)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    port = Adamax(model, mask, make_lr_schedule(1e-2, 1, 0.5, 1), 0.25)
    for s in range(steps):
        grads = {k: (rng.randn(*v.shape) * (0.01 if k == "b" else 1.0)).astype(np.float32)
                 for k, v in params.items()}
        updates, state = opt.update({k: jnp.asarray(g) for k, g in grads.items()}, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        port.step([torch.from_numpy(grads[n]) for n in port.names])
    adam = state[1][0]
    assert port.count == steps == int(adam.count)
    for i, n in enumerate(port.names):
        np.testing.assert_allclose(port.params[i].detach().numpy(), jparams[n], rtol=RTOL, atol=1e-7)
        np.testing.assert_allclose(port.mu[i].numpy(), adam.mu[n], rtol=RTOL, atol=1e-9)
        np.testing.assert_allclose(port.nu[i].numpy(), adam.nu[n], rtol=RTOL)
    np.testing.assert_array_equal(model.frozen.detach().numpy(), params["frozen"])
    assert np.abs(port.mu[2].numpy()).max() > 0.0


CFG = Config(
    num_hid=64, relation_dim=96, num_heads=4, nongt_dim=10, imp_pos_emb_dim=64,
    fusion="butd", relation_type="implicit", adaptive=True, residual_connection=True,
)


@pytest.mark.parametrize("fusion", ["butd", "ban", "mutan"])
@pytest.mark.parametrize("emb2_trainable", [False, True])
def test_trainable_mask_matches_jax(emb2_trainable, fusion):
    """Each fusion freezes its own attention bias: BUTD's scoring bias,
    BAN's h_bias, MuTAN's glimpse-scoring bias."""
    cfg = dataclasses.replace(CFG, fusion=fusion, mutan_rank=3)
    params = jax.eval_shape(lambda: init_regat(jax.random.PRNGKey(0), cfg, 25, 32, 11))
    want = flatten_tree(jax_trainable_mask(params, emb2_trainable))
    port_cfg = tconfig.Config(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tconfig.Config)}
    )
    got = trainable_mask(ReGAT(port_cfg, 25, 32, 11), emb2_trainable)
    assert {k.replace(".", "/"): v for k, v in got.items()} == {
        k: bool(v) for k, v in want.items()
    }
    assert sum(not v for v in got.values()) == (4 if emb2_trainable else 5)


@pytest.fixture(scope="module")
def stores():
    kw = dict(num_images=8, num_questions=37, v_dim=32, num_ans=30, seed=5)
    port = DeviceStore(synthetic_dataset(**kw), torch.device("cpu"))
    ref = JaxDeviceStore(jax_synthetic_dataset(**kw))
    return port, ref


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_indices_match_jax(stores, shuffle):
    port, ref = stores
    for epoch in (0, 3):
        got = list(port.epoch_indices(epoch, 16, shuffle, seed=42))
        want = list(ref.epoch_indices(epoch, 16, shuffle, 42))
        assert len(got) == len(want) == port.steps_per_epoch(16) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert (got[-1] == -1).sum() == 11


def test_gathered_batch_matches_jax(stores):
    """A padded last batch: targets, valid, num_boxes, questions, features
    and boxes equal the JAX gather's."""
    port, ref = stores
    idx = list(port.epoch_indices(1, 16, True, seed=7))[-1]
    R = 24
    got = gather_batch(port, torch.from_numpy(idx).long(), R)
    want = jax_gather_batch(ref.arrays, jnp.asarray(idx), R, 30, ref.padding_idx)
    for k in ("target", "valid", "num_boxes", "question", "features", "bb"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert not got["valid"][-11:].any() and not got["num_boxes"][-11:].any()
    assert (got["question"][-11:] == port.padding_idx).all()
    assert not got["target"][-11:].any() and got["target"][:5].sum() > 0


def test_soft_target_packing_is_loud():
    ds = synthetic_dataset(num_images=8, num_questions=10, v_dim=8, num_ans=30, seed=1)
    ent = ds.entries
    ent.labels[1] = ent.labels[0]  # entry 0 has >= 2 labels by the fixed seed
    assert ent.label_offsets[1] >= 2
    with pytest.raises(ValueError, match="duplicate answer labels"):
        pack_soft_targets(ent, 30)
    ent.label_offsets[1:] += 20
    ent.labels = np.arange(len(ent.labels) + 20, dtype=np.int32) % 30
    with pytest.raises(ValueError, match="MAX_LABELS"):
        pack_soft_targets(ent, 30)
