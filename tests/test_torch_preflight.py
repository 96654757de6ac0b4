"""tf_vqa_regat_tpu_torch/preflight.py, the port's real-dataset preflight,
against tools/preflight.py on the CPU, over JAX fixtures (HDF5, from
`write_fixture`) and their copies converted by the port's data/convert.py:
the device-table estimates and the eval-only `auto` resolutions per
feature dtype, the joint `--mode train` resolution (one process) on a grid
of budgets, and the int8 check equal to the JAX tool's; the JSON report,
and a missing file failing the run. Exact comparisons throughout.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from tf_vqa_regat_tpu.data.dictionary import Dictionary as JaxDictionary
from tf_vqa_regat_tpu.data.entries import EntryTable as JaxEntryTable
from tf_vqa_regat_tpu.data.entries import question_path as jax_question_path
from tf_vqa_regat_tpu.data.features import VQADataset as JaxVQADataset
from tf_vqa_regat_tpu.data.features import load_feature_store as jax_load_feature_store
from tf_vqa_regat_tpu.data.fixtures import write_fixture
from tf_vqa_regat_tpu_torch import preflight
from tf_vqa_regat_tpu_torch.data.convert import convert

# small CPU ops run fastest on one thread, and the suite runs several
# workers on the same cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_preflight_tool", os.path.join(REPO, "tools", "preflight.py"))
jax_tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_tool)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    out = {}
    for adaptive in (True, False):
        root = str(tmp_path_factory.mktemp("ad" if adaptive else "fx"))
        write_fixture(root, num_images=10, num_questions=40, v_dim=64, num_ans=13,
                      adaptive=adaptive, name="train", seed=0, semantic=True)
        write_fixture(root, num_images=8, num_questions=30, v_dim=64, num_ans=13,
                      adaptive=adaptive, name="val", seed=1, semantic=True,
                      first_image_id=2000, first_question_id=100)
        convert(root, ["train", "val"])
        out[adaptive] = root
    return out


def jax_sized_split(root, name, adaptive, relation_type):
    """The split tools/preflight.py's main builds (its feature store lazy)."""
    store = jax_load_feature_store(root, name, adaptive, relation_type, mmap=True)
    with open(jax_question_path(root, name)) as fh:
        n_q = len(json.load(fh)["questions"])
    n_img = store.pos_boxes.shape[0] if store.adaptive else store.features.shape[0]
    ent = JaxEntryTable(
        question_ids=np.zeros(n_q, np.int64), image_ids=np.zeros(n_q, np.int64),
        image_index=(np.arange(n_q) % max(n_img, 1)).astype(np.int32),
        q_tokens=np.zeros((n_q, 14), np.int32), label_offsets=np.zeros(n_q + 1, np.int64),
        labels=np.zeros(0, np.int32), scores=np.zeros(0, np.float32), has_answers=False)
    return JaxVQADataset(name=name, entries=ent, store=store, num_ans=3129, label2ans=[],
                         dictionary=JaxDictionary(), relation_type=relation_type, ntoken=19901)


@pytest.mark.parametrize("relation_type", ["implicit", "semantic"])
@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "fixed36"])
def test_estimates_and_resolutions_equal_the_jax_tool(roots, adaptive, relation_type):
    root = roots[adaptive]
    ours = {n: preflight.sized_split(root, n, adaptive, relation_type) for n in ("train", "val")}
    ref = {n: jax_sized_split(root, n, adaptive, relation_type) for n in ("train", "val")}
    try:
        rows = preflight.estimate_tables(ours["val"], 8.0, relation_type)
        sizes = sorted({x for n in ours for dp in (2, 4) for _, b, sh, _ in
                        preflight.estimate_tables(ours[n], 8.0, relation_type, dp)
                        for x in (b, sh)})
        budgets = sorted({f * b / 1e9 for b in sizes for f in (0.5, 1.0, 2.0, 2.01)})
        seen = set()
        for budget in budgets:
            for name in ("train", "val"):
                for dp in (1, 2, 4):
                    got = preflight.estimate_tables(ours[name], budget, relation_type, dp)
                    want = jax_tool.estimate_tables(ref[name], dp, budget, relation_type)
                    assert got == want, (name, budget, dp)
                    seen |= {m for *_, m in got}
            for dp in (1, 2, 4):
                got = preflight.train_run_modes(ours["train"], ours["val"], budget,
                                                relation_type, dp)
                assert got == jax_tool.train_run_modes(ref["train"], ref["val"], dp, budget,
                                                       relation_type)
                seen |= set(got.values())
        assert seen == {"device", "sharded", "host"}
        assert [d for d, *_ in rows] == list(preflight.DTYPES)
        for name in ("train", "val"):
            assert preflight.int8_check(ours[name].store.features, 100) == \
                jax_tool.int8_check(ref[name].store.features, 100)
    finally:
        for ds in ref.values():
            ds.store.h5_file.close()


def test_json_report_and_missing_files(roots, capsys):
    root = roots[True]
    preflight.main(["--data_folder", root, "--adaptive", "--budget_gb", "0.0001", "--json",
                    "--relation_type", "semantic", "--dp", "1"])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["ok"] and rep["card"] is None and rep["dp"] == 1
    assert set(rep["train_run_auto_mode"].values()) == {"host"}
    for name in ("train", "val"):
        split = rep["splits"][name]
        assert split["missing"] == []
        assert any(f["path"].endswith(os.path.join(name, "meta.json")) for f in split["files"])
        est = {e["feature_dtype"]: e["device_bytes"] for e in split["estimates"]}
        assert est["int8"] < est["bfloat16"] < est["float32"]
        shard = {e["feature_dtype"]: e["per_shard_bytes"] for e in split["estimates"]}
        assert shard["int8"] < shard["bfloat16"] < shard["float32"]
        assert split["int8_check"]["n_sampled"] > 0
    os.rename(os.path.join(root, "Bottom-up-features-adaptive", "val", "meta.json"),
              os.path.join(root, "meta.json.away"))
    try:
        with pytest.raises(SystemExit):
            preflight.main(["--data_folder", root, "--adaptive"])
        out = capsys.readouterr().out
        assert "MISSING" in out and "PREFLIGHT: missing files" in out
    finally:
        os.rename(os.path.join(root, "meta.json.away"),
                  os.path.join(root, "Bottom-up-features-adaptive", "val", "meta.json"))
