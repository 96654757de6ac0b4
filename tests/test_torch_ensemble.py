"""The port's `--mode ensemble_eval` (train/ensemble.py, main.py) on the CPU
against the JAX package's run_ensemble_eval (device data path, impl "jnp":
no Pallas call) on the same members' parameters and the same synthetic
split (drawn with the semantic table, as both entry points draw it for an
ensemble with a semantic member): implicit+semantic and
implicit+spatial+semantic. Also `parse_members`, the loud error on a member
trained under other flags, and the entry point's split.

Ties: an example whose top two averaged probabilities lie within TIE_ATOL
may take either answer between the packages (their probabilities differ by
~1e-7); those are counted and printed, the score may differ by at most their
targets' difference at the two answers, and outside that the scores are
equal at rel 1e-6.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.data.fixtures import synthetic_dataset as jax_synthetic_dataset
from tf_vqa_regat_tpu.models.regat import init_regat
from tf_vqa_regat_tpu.parallel.mesh import make_mesh
from tf_vqa_regat_tpu.train import checkpoint as jax_ckpt
from tf_vqa_regat_tpu.train.ensemble import run_ensemble_eval as jax_run_ensemble_eval
from tf_vqa_regat_tpu.train.logging import Logger as JaxLogger
from tf_vqa_regat_tpu_torch.config import Config, parse_with_config
from tf_vqa_regat_tpu_torch.data.store import DeviceStore
from tf_vqa_regat_tpu_torch.data.synthetic import synthetic_dataset
from tf_vqa_regat_tpu_torch.main import build_dataset, main
from tf_vqa_regat_tpu_torch.params import flatten_tree
from tf_vqa_regat_tpu_torch.train.ensemble import (
    averaged_probs,
    load_members,
    member_adj_tables,
    parse_members,
    run_ensemble_eval,
)
from tf_vqa_regat_tpu_torch.train.logging import Logger

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V_DIM, NUM_ANS = 16, 7
SPLIT = dict(num_images=8, num_questions=43, v_dim=V_DIM, num_ans=NUM_ANS, seed=5,
             semantic=True, name="val")
TIE_ATOL = 1e-5
CPU = torch.device("cpu")


def _cfg(**kw):
    base = dict(
        num_hid=32, relation_dim=48, num_heads=4, nongt_dim=6, imp_pos_emb_dim=16,
        fusion="butd", relation_type="implicit", residual_connection=True, adaptive=True,
        num_rois=40, batch_size=64, mode="ensemble_eval",
    )
    base.update(kw)
    return Config(**base)


def _jax_cfg(cfg):
    return JaxConfig(**{**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(Config)},
                        "data_mode": "device"})


def test_parse_members():
    assert parse_members("implicit:/a/b,spatial:/c/d, semantic:/e") == [
        ("implicit", "/a/b"), ("spatial", "/c/d"), ("semantic", "/e")]
    for bad in ("bogus:/a", "", " , "):
        with pytest.raises(ValueError):
            parse_members(bad)


@pytest.fixture(scope="module")
def members(tmp_path_factory):
    """Per relation type: (orbax dir of the JAX init, .npz of the same)."""
    tmp = tmp_path_factory.mktemp("members")
    ntoken = synthetic_dataset(**SPLIT).ntoken
    out = {}
    for i, rt in enumerate(("implicit", "spatial", "semantic")):
        params = init_regat(jax.random.PRNGKey(10 + i), _jax_cfg(_cfg(relation_type=rt)),
                            ntoken, V_DIM, NUM_ANS)
        orbax = jax_ckpt.save_params_only(str(tmp / rt), rt, "butd", params)
        npz = str(tmp / f"{rt}.npz")
        np.savez(npz, **flatten_tree(jax.tree.map(np.asarray, params)))
        out[rt] = (orbax, npz)
    return out


@pytest.mark.parametrize("rts", [("implicit", "semantic"), ("implicit", "spatial", "semantic")])
def test_score_equals_jax_run_ensemble_eval(tmp_path, members, rts, capsys):
    cfg = _cfg()
    jcfg = _jax_cfg(cfg).replace(
        ensemble_checkpoints=",".join(f"{rt}:{members[rt][0]}" for rt in rts))
    want = jax_run_ensemble_eval(
        jcfg, jax_synthetic_dataset(adaptive=True, **SPLIT), make_mesh(), "jnp",
        JaxLogger(str(tmp_path / "jax_log.txt")))
    cfg = cfg.replace(ensemble_checkpoints=",".join(f"{rt}:{members[rt][1]}" for rt in rts))
    ds = synthetic_dataset(**SPLIT)
    logger = Logger(str(tmp_path / "log.txt"))
    got = run_ensemble_eval(cfg, ds, CPU, logger)
    assert f"[ensemble] members={list(rts)} data=device score={got:.4f}" in capsys.readouterr().out

    # ties: bound what they may move, and hold the rest equal
    store = DeviceStore(ds, CPU)
    loaded = load_members(cfg, ds, CPU, logger)
    tables = member_adj_tables(loaded, ds, CPU)
    slack, ties = 0.0, 0
    for idx in store.epoch_indices(0, 16, False, cfg.seed):
        probs, batch = averaged_probs(loaded, store, torch.from_numpy(idx).long(), 40, tables)
        top2 = probs.topk(2, dim=-1)
        tied = ((top2.values[:, 0] - top2.values[:, 1]) <= TIE_ATOL) & batch["valid"]
        t = batch["target"].gather(1, top2.indices)
        slack += float((t[:, 0] - t[:, 1]).abs()[tied].sum())
        ties += int(tied.sum())
    print(f"{ties} of 43 examples tied within {TIE_ATOL}")
    assert ties < 10 and 0.0 < want < 100.0
    assert abs(got - want) <= 100.0 * slack / 43 + 1e-6 * abs(want)
    if ties == 0:
        assert got == pytest.approx(want, rel=1e-6)


def test_member_trained_under_other_flags_is_refused(tmp_path, members):
    """A spatial member saved without the label-bias FC does not load under
    --label_bias: the error names the member."""
    cfg = _cfg(label_bias=True, ensemble_checkpoints=(
        f"implicit:{members['implicit'][1]},spatial:{members['spatial'][1]}"))
    with pytest.raises(ValueError, match="ensemble member spatial:.*this run's flags"):
        load_members(cfg, synthetic_dataset(**SPLIT), CPU, Logger(str(tmp_path / "l.txt")))


def test_entry_point_draws_the_split_with_the_semantic_table(tmp_path, capsys):
    """An ensemble with a semantic member draws the val split with the
    semantic table, as the JAX entry point does (its answers differ from the
    split drawn without it), and prints the final score."""
    import main as jax_main
    from tf_vqa_regat_tpu.config import parse_with_config as jax_parse_with_config
    from tf_vqa_regat_tpu_torch.models.regat import ReGAT
    from tf_vqa_regat_tpu_torch.params import save_npz

    argv = ["--num_hid", "32", "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6",
            "--imp_pos_emb_dim", "16", "--fusion", "butd", "--residual_connection",
            "--adaptive", "--num_rois", "40", "--synthetic", "--synthetic_val_size", "24",
            "--mode", "ensemble_eval", "--output", str(tmp_path) + "/"]
    paths = {}
    for rt in ("implicit", "semantic"):
        paths[rt] = str(tmp_path / f"{rt}.npz")
        save_npz(paths[rt], ReGAT(parse_with_config(argv + ["--relation_type", rt]),
                                  24, 2048, 3129))
    spec = ["--ensemble_checkpoints", ",".join(f"{rt}:{p}" for rt, p in paths.items())]
    ds = build_dataset(parse_with_config(argv + spec))
    _, ref, _, _ = jax_main.build_datasets(jax_parse_with_config(argv + spec))
    assert ds.store.semantic_adj is not None and np.array_equal(ds.store.semantic_adj,
                                                               ref.store.semantic_adj)
    assert np.array_equal(ds.entries.labels, ref.entries.labels)
    plain = build_dataset(parse_with_config(
        argv + ["--ensemble_checkpoints", f"implicit:{paths['implicit']}"]))
    assert plain.store.semantic_adj is None
    assert not np.array_equal(plain.entries.labels, ds.entries.labels)
    score = main(argv + spec + ["--device", "cpu"])
    assert 0.0 <= score <= 100.0
    assert f"Final ensemble eval score: {score:.4f}" in capsys.readouterr().out
