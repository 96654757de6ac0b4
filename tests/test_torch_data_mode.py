"""The port's data-mode policy and its host branches against the JAX
package, on the CPU:

(a) the Config fields `data_mode`, `device_store_budget_gb` and `prefetch`
    parse as JAX's; `--data_mode sharded` parses, and `--tp_size 2` is
    refused, naming the multi-device item;
(b) `estimate_nbytes` equals JAX's `device_store.estimate_nbytes` to the
    byte (each feature dtype, with and without the edge labels, adaptive
    and fixed-36, implicit, spatial and semantic splits);
(c) `resolve_data_mode` equals JAX's (one process) on a grid of budgets
    around the estimates, for train and val and for eval only, with and
    without the ensemble's extra bytes;
(d) whole runs at tiny widths through `main.main`: `--data_mode host`
    train -> eval -> predict equals `--data_mode device` bit for bit (f32
    butd, bf16 semantic), `auto` under a tiny budget logs and takes the host
    path, a host-mode run preempted mid-epoch and resumed equals the
    uninterrupted one and leaves no prefetch thread, a resume across modes
    is refused, the ensemble's host stream scores as the device path;
(e) refusals: `--roi_buckets` with `host`, serve over the budget.

Tolerances: none; the CPU runs are deterministic, so host and device runs
and a resumed run are held equal bit for bit.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.config import Config as JaxConfig
from tf_vqa_regat_tpu.data import device_store as jds
from tf_vqa_regat_tpu.data import entries as jax_entries
from tf_vqa_regat_tpu.data import features as jax_features
from tf_vqa_regat_tpu.train.loop import resolve_data_mode as jax_resolve_data_mode
from tf_vqa_regat_tpu_torch.config import Config, parse_with_config
from tf_vqa_regat_tpu_torch.data.features import load_vqa_dataset
from tf_vqa_regat_tpu_torch.data.store import estimate_nbytes
from tf_vqa_regat_tpu_torch.data.synthetic import make_dictionary, write_dataset
from tf_vqa_regat_tpu_torch.main import build_dataset, build_server, main, parse
from tf_vqa_regat_tpu_torch.models.regat import ReGAT
from tf_vqa_regat_tpu_torch.params import save_npz
from tf_vqa_regat_tpu_torch.train import checkpoint as ckpt
from tf_vqa_regat_tpu_torch.train import ensemble
from tf_vqa_regat_tpu_torch.train.logging import Logger
from tf_vqa_regat_tpu_torch.train.loop import resolve_data_mode

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
DTYPES = ("float32", "bfloat16", "int8")
WIDTHS = ["--num_hid", "32", "--relation_dim", "48", "--num_heads", "4", "--nongt_dim", "6"]
SMALL = [*WIDTHS, "--num_rois", "24", "--synthetic", "--synthetic_train_size", "40",
         "--synthetic_val_size", "20", "--batch_size", "16", "--print_freq", "0",
         "--device", "cpu", "--no-async_checkpoint"]


def argv(config, out, *extra):
    return ["--config", os.path.join(REPO, "configs", config), *SMALL, "--output",
            str(out) + "/", *extra]


def small_model(config, path, relation_type=None, mode="eval", spec=""):
    """An .npz of a freshly built small model under `config`, sized to the
    synthetic split its entry point reads."""
    cfg = parse_with_config(["--config", os.path.join(REPO, "configs", config), *WIDTHS,
                             "--num_rois", "24", "--mode", mode,
                             "--ensemble_checkpoints", spec])
    if relation_type:
        cfg = cfg.replace(relation_type=relation_type)
    ds = build_dataset(cfg)
    save_npz(path, ReGAT(cfg, ds.ntoken, ds.v_dim, ds.num_ans))
    return path


# ------------------------------------------------------------------ (a)
def test_config_fields_and_the_sharded_refusal():
    jax_fields = {f.name: f for f in dataclasses.fields(JaxConfig)}
    for name in ("data_mode", "device_store_budget_gb", "prefetch"):
        f = {g.name: g for g in dataclasses.fields(Config)}[name]
        assert (f.type, f.default) == (jax_fields[name].type, jax_fields[name].default)
    cfg = parse_with_config(["--data_mode", "host", "--device_store_budget_gb", "70",
                             "--prefetch", "0"])
    assert (cfg.data_mode, cfg.device_store_budget_gb, cfg.prefetch) == ("host", 70.0, 0)
    assert parse_with_config(["--data_mode", "sharded"]).data_mode == "sharded"
    # tensor parallelism: a tp that divides the heads and the classifier's
    # hidden width is taken; one that does not is refused by name
    assert parse_with_config(["--tp_size", "2", "--num_heads", "16"]).tp_size == 2
    with pytest.raises(ValueError, match="--tp_size 3 does not divide --num_heads = 16"):
        parse_with_config(["--tp_size", "3", "--num_heads", "16"])
    with pytest.raises(ValueError, match="auto|device|host|sharded"):
        parse_with_config(["--data_mode", "disk"])


# ------------------------------------------------------------------ (b), (c)
@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """(port train, port val, JAX train, JAX val) per (layout, relation
    type), over files written from one seed."""
    out = {}
    for adaptive in (True, False):
        root = str(tmp_path_factory.mktemp("ad" if adaptive else "fx"))
        write_dataset(root, num_images=7, num_questions=23, v_dim=40, num_ans=9,
                      adaptive=adaptive, name="train", seed=1, semantic=True, spatial_seed=2)
        write_dataset(root, num_images=5, num_questions=11, v_dim=40, num_ans=9,
                      adaptive=adaptive, name="val", seed=3, semantic=True, spatial_seed=4,
                      first_image_id=2000, first_question_id=100)
        for rt in ("implicit", "spatial", "semantic"):
            port = [load_vqa_dataset(name, make_dictionary(), rt, root, adaptive)
                    for name in ("train", "val")]
            out[adaptive, rt] = (*port, *map(jax_split, port))
    return out


def jax_split(ds):
    s = ds.store
    store = jax_features.FeatureStore(
        adaptive=s.adaptive, features=s.features, normalized_bb=s.normalized_bb, bb=s.bb,
        pos_boxes=s.pos_boxes, semantic_adj=s.semantic_adj, spatial_adj=s.spatial_adj)
    ent = jax_entries.EntryTable(**{f.name: getattr(ds.entries, f.name)
                                    for f in dataclasses.fields(ds.entries)})
    return jax_features.VQADataset(
        name=ds.name, entries=ent, store=store, num_ans=ds.num_ans, label2ans=ds.label2ans,
        dictionary=ds.dictionary, relation_type=ds.relation_type, ntoken=ds.ntoken)


LAYOUTS = [(a, rt) for a in (True, False) for rt in ("implicit", "spatial", "semantic")]
LAYOUT_IDS = [f"{'adaptive' if a else 'fixed36'}-{rt}" for a, rt in LAYOUTS]


@pytest.mark.parametrize("key", LAYOUTS, ids=LAYOUT_IDS)
def test_estimate_nbytes_equals_jax(splits, key):
    for ours, ref in zip(splits[key][:2], splits[key][2:]):
        for dtype in DTYPES:
            for include_adj in (False, True):
                got = estimate_nbytes(ours, include_adj, dtype)
                assert got == jds.estimate_nbytes(ref, include_adj, dtype), (dtype, include_adj)
        if key[1] != "implicit":  # the edge-label table counts, a byte an element
            assert (estimate_nbytes(ours, True) - estimate_nbytes(ours, False)
                    == ours.store.num_images * 100 * 100)


@pytest.mark.parametrize("key", LAYOUTS, ids=LAYOUT_IDS)
def test_resolve_data_mode_equals_jax_on_a_grid(splits, key):
    train, val, jtrain, jval = splits[key]
    include_adj = key[1] != "implicit"
    seen = set()
    for dtype in DTYPES:
        for extra in (0, 12345):
            for with_train in (True, False):
                ests = [estimate_nbytes(ds, include_adj, dtype) + extra
                        for ds in ((train, val) if with_train else (val,))]
                budgets = sorted({f * e + d for e in ests for f in ((1, 2) if with_train else (1,))
                                  for d in (-1, 0, 1)})
                for b in budgets:
                    cfg = Config(feature_dtype=dtype, device_store_budget_gb=b / 1e9,
                                 relation_type=key[1])
                    jcfg = JaxConfig(feature_dtype=dtype, device_store_budget_gb=b / 1e9,
                                     relation_type=key[1])
                    got = resolve_data_mode(cfg, val, train if with_train else None,
                                            include_adj, extra)
                    want = jax_resolve_data_mode(jcfg, jval, jtrain if with_train else None,
                                                 include_adj, 1, extra)
                    assert got == want, (dtype, extra, with_train, b)
                    seen.add(got)
    assert seen == {"device", "host"}
    for mode in ("device", "host"):  # a forced mode is taken as given
        cfg = Config(data_mode=mode, device_store_budget_gb=1e-9)
        assert resolve_data_mode(cfg, val, train, include_adj) == mode


# ------------------------------------------------------------------ (d)
RUNS = {"butd-f32": ("butd_vqa.json", ()),
        "semantic-bf16": ("semantic_vqa.json", ("--feature_dtype", "bfloat16"))}


def _params(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as fh:
        return [{k: v for k, v in json.loads(line).items() if k not in ("ts",) and "time" not in k
                 and k != "train_qps"} for line in fh]


def _log(out, name="log.txt"):
    with open(os.path.join(out, name)) as fh:
        return [ln for ln in fh.read().splitlines() if ln.startswith("[data]")]


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "regat-prefetch"]


@pytest.mark.parametrize("run", list(RUNS))
def test_host_run_equals_device_run(tmp_path, run):
    config, extra = RUNS[run]
    got = {}
    for mode in ("device", "host"):
        out = tmp_path / mode
        flags = (*extra, "--data_mode", mode, "--epochs", "2")
        path = main(argv(config, out, *flags, "--mode", "train"))
        score, loss = main(argv(config, out, *flags, "--mode", "eval", "--checkpoint", path))
        pred = main(argv(config, out, *flags, "--mode", "predict", "--checkpoint", path))
        with open(pred) as fh:
            answers = json.load(fh)
        got[mode] = (_params(path), _metrics(out), loss, score, answers)
        assert [f"data={mode} (--data_mode {mode})" in ln for ln in _log(out)] == [True]
        assert _log(out, "eval_log.txt")[0].startswith(f"[data] data={mode}")
    (pd, md, ld, sd, ad), (ph, mh, lh, sh, ah) = got["device"], got["host"]
    assert sorted(pd) == sorted(ph) and all(np.array_equal(pd[k], ph[k]) for k in pd)
    assert md == mh and (ld, sd) == (lh, sh) and ad == ah
    assert ld == md[-1]["eval_loss"]
    assert not _prefetch_threads()


def test_auto_takes_the_host_path_over_the_budget(tmp_path):
    flags = ("--data_mode", "auto", "--device_store_budget_gb", "0.001", "--epochs", "1")
    main(argv("butd_vqa.json", tmp_path, *flags, "--mode", "train"))
    (line,) = _log(tmp_path)
    assert line.startswith("[data] data=host (--data_mode auto): train ")
    assert "0.0005 GB per split (--device_store_budget_gb 0.001, halved for a train split)" \
        in line
    with open(os.path.join(tmp_path, "checkpoints", "meta.json")) as fh:
        assert json.load(fh)["run"]["data_mode"] == "host"


def test_host_mid_epoch_resume_is_exact_and_across_modes_is_refused(tmp_path, monkeypatch):
    flags = ("--epochs", "2", "--mode", "train", "--checkpoint_every_steps", "1")
    host = ("--data_mode", "host")
    uninterrupted = _params(main(argv("butd_vqa.json", tmp_path / "a", *flags, *host)))
    monkeypatch.setenv("REGAT_FAULT_PREEMPT_STEP", "4")
    assert main(argv("butd_vqa.json", tmp_path / "b", *flags, *host)) is None
    assert main(argv("butd_vqa.json", tmp_path / "c", *flags, "--data_mode", "device")) is None
    monkeypatch.delenv("REGAT_FAULT_PREEMPT_STEP")
    assert not _prefetch_threads()  # the preemption closed the stream
    meta = ckpt.restore_meta_full(str(tmp_path / "b"))
    assert (meta["epoch"], meta["step_in_epoch"], meta["run"]["data_mode"]) == (1, 1, "host")
    resumed = _params(main(argv("butd_vqa.json", tmp_path / "b", *flags, *host, "--resume")))
    assert all(np.array_equal(uninterrupted[k], resumed[k]) for k in uninterrupted)
    assert _metrics(tmp_path / "a")[-1] == _metrics(tmp_path / "b")[-1]
    with pytest.raises(ValueError, match="'data_mode': \\('device', 'host'\\)"):
        main(argv("butd_vqa.json", tmp_path / "c", *flags, *host, "--resume"))


def test_host_ensemble_scores_as_the_device_path(tmp_path):
    spec = ",".join(
        f"{rt}:" + small_model("semantic_vqa.json", str(tmp_path / f"{rt}.npz"), rt,
                               "ensemble_eval", "semantic:x")
        for rt in ("implicit", "spatial", "semantic"))
    scores = {}
    for mode in ("device", "host"):
        out = tmp_path / mode
        scores[mode] = main(argv("semantic_vqa.json", out, "--mode", "ensemble_eval",
                                 "--ensemble_checkpoints", spec, "--data_mode", mode))
        assert _log(out, "eval_log.txt")[0].startswith(f"[data] data={mode}")
    assert scores["device"] == scores["host"]
    # batch by batch: the same batches and averaged probabilities
    cfg = parse(argv("semantic_vqa.json", tmp_path, "--mode", "ensemble_eval",
                     "--ensemble_checkpoints", spec))[0]
    ds = build_dataset(cfg)
    members = ensemble.load_members(cfg, ds, CPU, Logger(str(tmp_path / "cmp.txt")))
    sources = ensemble.member_adj_sources(members, ds)
    n = 0
    for (ph, bh), (pd, bd) in zip(ensemble._host_passes(cfg, ds, CPU, members, sources),
                                  ensemble._resident_passes(cfg, ds, CPU, members, sources)):
        assert torch.equal(ph, pd) and all(torch.equal(bh[k], bd[k]) for k in bd)
        n += 1
    assert n == -(-len(ds) // cfg.resolved_eval_batch()) and not _prefetch_threads()


# ------------------------------------------------------------------ (e)
def test_roi_buckets_on_the_host_path_and_serve_over_the_budget_are_refused(tmp_path):
    with pytest.raises(ValueError, match="--roi_buckets requires the device or sharded"):
        main(argv("butd_vqa.json", tmp_path, "--data_mode", "host", "--roi_buckets", "24,36",
                  "--mode", "train", "--epochs", "1"))
    path = small_model("butd_vqa.json", str(tmp_path / "m.npz"))
    serve = argv("butd_vqa.json", tmp_path, "--mode", "serve", "--checkpoint", path,
                 "--serve_port", "0")
    with pytest.raises(ValueError, match="Use --feature_dtype int8 .* raise "
                                         "--device_store_budget_gb"):
        build_server(serve + ["--device_store_budget_gb", "0.0001"])
    with pytest.raises(ValueError, match="budget is 0.00 GB .* Raise --device_store_budget_gb"):
        build_server(serve + ["--device_store_budget_gb", "0.00001", "--feature_dtype", "int8"])
    server, batcher, _ = build_server(serve)  # the default budget holds it
    batcher.close()
    server.server_close()
