"""The data-parallel train step of the port (train/step.py: `grad_sums`,
`FlatSums`, `apply_sums`) and its topology helpers (parallel/), on the CPU:

- the reduced step against the JAX package's SPMD step: from the same
  parameters (carried by params.py) at --dropout 0, three steps of JAX's
  `build_sharded_store_train_step` on a dp = 2 mesh of the virtual CPU
  devices, against the port's two shards built per rank in this process
  (each its own ShardedDeviceStore, model and Adamax), each rank's gradient
  sums added as the all-reduce adds them and applied on both ranks: implicit
  (B1's plain version) at --grad_accum 1 and 2, and semantic (B2's plain
  version, with the sharded semantic adjacency). The epoch's last step has
  unequal valid counts on the two shards (the padded tail);
- on that step (one shard's rows run out first), the summed gradient sums
  over the summed count equal the one-process gradient of the same rows,
  and the mean of the ranks' own means (DDP's average) does not;
- the two ranks' parameters stay bit-identical;
- `make_mesh`, `batch_slice`, the card mapping (two NCCL ranks on one card
  refused), `maybe_initialize` leaving an open group alone, the collectives
  on a gloo group of one process, and the batch refusals of
  `check_grad_accum` with JAX's messages.

Tolerances: JAX's own data-parallel ones (tests/test_parallel.py:48-60):
losses and scores rtol 1e-5, parameters rtol 2e-3 and atol 1e-4; the two
ranks exactly equal.
"""

import dataclasses
import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.data import entries as jax_entries
from tf_vqa_regat_tpu.data import features as jax_features
from tf_vqa_regat_tpu.data.sharded_store import ShardedDeviceStore as JaxShardedStore
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.models.regat import trainable_mask as jax_trainable_mask
from tf_vqa_regat_tpu.parallel.mesh import batch_sharding
from tf_vqa_regat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tf_vqa_regat_tpu.train.optim import make_optimizer
from tf_vqa_regat_tpu.train.step import build_sharded_store_train_step, init_train_state
from tf_vqa_regat_tpu_torch.config import Config
from tf_vqa_regat_tpu_torch.data.sharded_store import ShardedDeviceStore
from tf_vqa_regat_tpu_torch.data.store import DeviceStore, gather_batch
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.models.regat import ReGAT, trainable_mask
from tf_vqa_regat_tpu_torch.parallel import distributed
from tf_vqa_regat_tpu_torch.parallel.mesh import Mesh, batch_slice, make_mesh
from tf_vqa_regat_tpu_torch.parallel.tensor import TensorParallel
from tf_vqa_regat_tpu_torch.params import flatten_tree, load_jax_arrays
from tf_vqa_regat_tpu_torch.train import step as tstep
from tf_vqa_regat_tpu_torch.train.loop import check_grad_accum
from tf_vqa_regat_tpu_torch.train.optim import Adamax, make_lr_schedule

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
V_DIM, NUM_ANS, R, B, DP = 32, 9, 12, 16, 2
STEPS = 3
CFG = JaxConfig(
    num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
    fusion="butd", relation_type="implicit", adaptive=True, num_rois=R,
    residual_connection=True, base_lr=1e-3, dropout=0.0, batch_size=B, seed=5,
)


def _port_cfg(cfg):
    return Config(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)})


def jax_split(ds):
    """The port's split as the JAX package's VQADataset (the same arrays)."""
    s = ds.store
    store = jax_features.FeatureStore(
        adaptive=s.adaptive, features=s.features, normalized_bb=s.normalized_bb, bb=s.bb,
        pos_boxes=s.pos_boxes, semantic_adj=s.semantic_adj, spatial_adj=s.spatial_adj)
    ent = jax_entries.EntryTable(**{f.name: getattr(ds.entries, f.name)
                                    for f in dataclasses.fields(ds.entries)})
    return jax_features.VQADataset(
        name=ds.name, entries=ent, store=store, num_ans=ds.num_ans, label2ans=ds.label2ans,
        dictionary=ds.dictionary, relation_type=ds.relation_type, ntoken=ds.ntoken)


def _dataset(relation_type):
    ds = synthetic_dataset(num_images=8, num_questions=40, v_dim=V_DIM, num_ans=NUM_ANS,
                           seed=3, semantic=relation_type == "semantic")
    return dataclasses.replace(ds, relation_type=relation_type)


def _jax_run(ds, cfg, flat):
    """JAX's sharded-store step on a dp = 2 mesh: per step (loss, score, n)
    and the final parameters; with the index batches it ran."""
    jds = jax_split(ds)
    mesh = jax_make_mesh(DP, 1, devices=jax.devices()[:DP])
    store = JaxShardedStore(jds, mesh, include_adj=cfg.relation_type == "semantic")
    params = init_regat(jax.random.PRNGKey(0), cfg, ds.ntoken, V_DIM, NUM_ANS)
    n_steps = store.steps_per_epoch(cfg.batch_size)
    opt = make_optimizer(cfg.base_lr, cfg.grad_clip, n_steps, cfg.lr_decay_rate,
                         cfg.lr_decay_step, jax_trainable_mask(params, False))
    state = init_train_state(params, opt, mesh)
    step = build_sharded_store_train_step(cfg, ds.ntoken, opt, mesh, "jnp", params, NUM_ANS,
                                          store.padding_idx)
    rng = jax.random.PRNGKey(cfg.seed + 1)
    idxs = list(store.epoch_indices(0, cfg.batch_size, True, cfg.seed))[:STEPS]
    metrics = []
    for idx in idxs:
        state, m = step(state, store.arrays, jax.device_put(idx, batch_sharding(mesh)), rng)
        metrics.append({k: float(v) for k, v in m.items()})
    return idxs, metrics, flatten_tree(jax.tree.map(np.asarray, state["params"])), n_steps


def _port_ranks(ds, cfg, flat, n_steps):
    """The two ranks of the port, each with its shard, model and Adamax."""
    pcfg = _port_cfg(cfg)
    ranks = []
    for r in range(DP):
        store = ShardedDeviceStore(ds, CPU, r, DP,
                                   include_adj=cfg.relation_type == "semantic")
        model = ReGAT(pcfg, ds.ntoken, V_DIM, NUM_ANS)
        load_jax_arrays(model, flat)
        sched = make_lr_schedule(cfg.base_lr, n_steps, cfg.lr_decay_rate, cfg.lr_decay_step)
        opt = Adamax(model, trainable_mask(model, False), sched, cfg.grad_clip)
        ranks.append((store, model, opt, tstep.FlatSums(opt.params, CPU)))
    return ranks


def _port_step(ranks, idx, cfg, step):
    """One reduced step: each rank's sums of its rows of `idx`, summed over
    the ranks (the all-reduce), applied on every rank -> rank 0's metrics
    and each rank's local valid count."""
    local_n = []
    for r, (store, model, opt, sums) in enumerate(ranks):
        batch = gather_batch(store, torch.from_numpy(batch_slice(idx, r, DP)).long(), R)
        grads, loss_sum, score, n = tstep.grad_sums(model, opt.params, batch, step, cfg.seed,
                                                    cfg.grad_accum, rank=r)
        sums.write(grads, loss_sum, score, n)
        local_n.append(float(n))
    total = sum(s.flat for *_, s in ranks)
    out = []
    for store, model, opt, sums in ranks:
        sums.flat.copy_(total)
        out.append({k: float(v) for k, v in tstep.apply_sums(opt, sums).items()})
    assert out[0] == out[1]
    return out[0], local_n


def _params(model):
    return {n.replace(".", "/"): p.detach().numpy().copy() for n, p in model.named_parameters()}


CASES = {"implicit": CFG, "implicit-accum2": CFG.replace(grad_accum=2),
         "semantic": CFG.replace(relation_type="semantic")}


@pytest.mark.parametrize("name", list(CASES))
def test_the_reduced_step_equals_jax_dp2(name):
    cfg = CASES[name]
    ds = _dataset(cfg.relation_type)
    flat = flatten_tree(jax.tree.map(np.asarray, init_regat(
        jax.random.PRNGKey(0), cfg, ds.ntoken, V_DIM, NUM_ANS)))
    idxs, want, want_params, n_steps = _jax_run(ds, cfg, flat)
    assert len(idxs) == STEPS and all(idx.shape == (B,) for idx in idxs)
    ranks = _port_ranks(ds, cfg, flat, n_steps)
    got, counts = zip(*[_port_step(ranks, idx, cfg, i) for i, idx in enumerate(idxs)])
    for g, w in zip(got, want):
        assert g["n"] == w["n"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["score"], w["score"], rtol=1e-5, atol=1e-6)
    params = [_params(model) for _, model, _, _ in ranks]
    moved = 0.0
    for key, w in want_params.items():
        np.testing.assert_allclose(params[0][key], w, rtol=2e-3, atol=1e-4, err_msg=key)
        np.testing.assert_array_equal(params[0][key], params[1][key], err_msg=key)
        moved = max(moved, float(np.abs(w - flat[key]).max()))
    assert moved > 1e-3  # the parameters did move
    # the epoch's last step holds a padded tail: the shards' counts differ
    assert counts[-1][0] != counts[-1][1], counts


def test_no_rank_averages_its_gradient_before_the_global_division():
    """On the padded tail (unequal valid counts), the ranks' summed
    gradient sums over the summed count equal the gradient of the same rows
    taken in one process; the mean of the ranks' own means (DDP's average)
    does not."""
    ds = _dataset("implicit")
    flat = flatten_tree(jax.tree.map(np.asarray, init_regat(
        jax.random.PRNGKey(0), CFG, ds.ntoken, V_DIM, NUM_ANS)))
    ranks = _port_ranks(ds, CFG, flat, 3)
    last = list(ranks[0][0].epoch_indices(0, B, True, CFG.seed))[-1]
    parts = []
    for r, (store, model, opt, _) in enumerate(ranks):
        batch = gather_batch(store, torch.from_numpy(batch_slice(last, r, DP)).long(), R)
        grads, _, _, n = tstep.grad_sums(model, opt.params, batch, 0, CFG.seed)
        parts.append((grads, float(n)))
    (g0, n0), (g1, n1) = parts
    assert n0 + n1 > 0 and n0 != n1, (n0, n1)
    one = ReGAT(_port_cfg(CFG), ds.ntoken, V_DIM, NUM_ANS)
    load_jax_arrays(one, flat)
    rows = torch.from_numpy(ranks[0][0].to_global(last)).long()
    g_one, _, _, n_one = tstep.grad_sums(one, list(one.parameters()),
                                         gather_batch(DeviceStore(ds, CPU), rows, R), 0,
                                         CFG.seed)
    assert float(n_one) == n0 + n1
    worst_ddp = 0.0
    for a, b, w in zip(g0, g1, g_one):
        want = w / n_one
        scale = float(want.abs().max()) + 1e-12
        reduced = (a + b) / (n0 + n1)
        assert float((reduced - want).abs().max()) <= 1e-5 * scale
        ddp = (a / max(n0, 1.0) + b / max(n1, 1.0)) / 2
        worst_ddp = max(worst_ddp, float((ddp - want).abs().max()) / scale)
    assert worst_ddp > 0.05, worst_ddp


def test_mesh_and_batch_slice():
    assert make_mesh(0, 1, world=4, rank=3) == Mesh(dp=4, tp=1, rank=3, group=False)
    assert (make_mesh(2, 1, world=2, rank=0).dp, make_mesh(1, 2, world=2).tp) == (2, 2)
    with pytest.raises(ValueError, match="mesh 3x1 != 4 devices"):
        make_mesh(3, 1, world=4)
    with pytest.raises(ValueError, match="3 devices not divisible by tp=2"):
        make_mesh(0, 2, world=3)
    # rank r at (r // tp, r % tp), JAX's reshape(dp_size, tp_size)
    jax_grid = np.asarray(jax_make_mesh(2, 2, devices=jax.devices()[:4]).devices)
    for r in range(4):
        mesh = make_mesh(0, 2, world=4, rank=r)
        assert (mesh.dp, mesh.tp, mesh.data, mesh.model) == (2, 2, r // 2, r % 2)
        assert jax_grid[mesh.data, mesh.model] == jax.devices()[r]
        assert mesh.tensor_parallel() == TensorParallel(2, r % 2)
    assert make_mesh(0, 1, world=4, rank=3).tensor_parallel() is None
    idx = np.arange(16).reshape(2, 8)
    assert batch_slice(idx, 1, 4).tolist() == [[2, 3], [10, 11]]
    assert batch_slice(idx[0], 0, 1).tolist() == list(range(8))
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        batch_slice(idx, 0, 3)


def test_card_mapping_refuses_two_nccl_ranks_on_one_card():
    assert distributed.cuda_index(3, 4, 4, "nccl") == 3
    assert distributed.cuda_index(5, 8, 8, "nccl") == 5
    assert distributed.cuda_index(1, 2, 1, "gloo") == 0  # gloo may share the card
    with pytest.raises(ValueError, match="NCCL cannot run two ranks on one card"):
        distributed.cuda_index(1, 2, 1, "nccl")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.cuda_index(0, 1, 0, "nccl")
    assert distributed.backend_for("cuda") == "nccl" and distributed.backend_for("cpu") == "gloo"


def test_a_group_opened_by_the_caller_is_left_alone(monkeypatch):
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    assert not distributed.initialized()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    try:
        monkeypatch.setenv("REGAT_AUTO_DISTRIBUTED", "1")
        assert distributed.maybe_initialize("cpu") is False
        assert (distributed.rank(), distributed.world_size()) == (0, 1)
        a, b = torch.ones(3), torch.arange(4, dtype=torch.float32)
        distributed.all_reduce_([a, b])
        assert a.tolist() == [1.0] * 3 and b.tolist() == [0.0, 1.0, 2.0, 3.0]
        c = torch.tensor([2.0])
        distributed.all_reduce_([c], op="max")
        assert c.item() == 2.0 and distributed.any_rank(True) and not distributed.any_rank(False)
        assert make_mesh(0, 1).group
    finally:
        distributed.destroy()
    assert not distributed.initialized() and not make_mesh(0, 1).group


def test_without_environment_no_group_is_opened(monkeypatch):
    for k in ("REGAT_AUTO_DISTRIBUTED", "REGAT_COORDINATOR", "REGAT_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.maybe_initialize("cpu") is False and not distributed.initialized()
    monkeypatch.setenv("REGAT_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("REGAT_NUM_PROCESSES", "1")  # one process: no group, as JAX
    assert distributed.maybe_initialize("cpu") is False


@pytest.mark.parametrize("batch,k,dp,msg", [
    (15, 1, 2, "must be divisible by the data-mesh size 2"),
    (12, 4, 2, r"must be divisible by grad_accum\*dp = 4\*2"),
])
def test_batches_the_ranks_cannot_split_are_refused(batch, k, dp, msg):
    with pytest.raises(ValueError, match=msg):
        check_grad_accum(Config(batch_size=batch, grad_accum=k), dp)
    check_grad_accum(Config(batch_size=batch * dp * k, grad_accum=k), dp)
