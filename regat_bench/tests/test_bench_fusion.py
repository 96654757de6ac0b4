"""A configuration's fusion is found by its name (reference/fusion/): the
shared layout, forward, frozen set and operation count take the rest from
the fusion's file, and for the configurations of BENCHMARK.json they are
what they were while BUTD was written into them (the digests and counts
below were recorded from that layout)."""

import hashlib
import json

import pytest

from regat_bench import flops, manifest
from regat_bench.reference import fusion, params
from regat_bench.reference import regat as ref

# sha256 of [[name, shape, kind, bound], ...] in param_spec's order
SPEC = {"butd_vqa": (62, "e6a9a7e8e22052588204a24f732877bcd17f97eb20de775b5ad5d06a0000cb63"),
        "spatial_vqa": (59, "61bc879088cabbda9e1f56815bf7600f8cfb2506b986ad67a34fb82df3761040")}
# (forward, train) f32 operations per question at the published widths
FLOPS = {"butd_vqa": (1676569600.0, 4602086400.0), "spatial_vqa": (1668465600.0, 4585878400.0)}
FROZEN = ["w_emb.emb_.table", "q_att.linear2.layers.0.b", "joint_emb.linear.layers.0.b",
          "v_relation.gatt.neighbor.0.key.layers.0.b", "v_relation.gatt.neighbor.1.key.layers.0.b"]


def _cfg(name: str) -> dict:
    return manifest.Manifest().config(name)


@pytest.mark.parametrize("name", sorted(SPEC))
def test_param_spec_is_the_recorded_layout(name):
    spec = params.param_spec(_cfg(name))
    digest = hashlib.sha256(json.dumps([[n, list(s), k, b] for n, s, k, b in spec]).encode())
    assert (len(spec), digest.hexdigest()) == SPEC[name]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flops_and_frozen_are_the_recorded_ones(name):
    cfg = _cfg(name)
    assert (flops.forward_flops(cfg), flops.train_flops(cfg)) == FLOPS[name]
    assert ref.frozen(cfg, [n for n, *_ in params.param_spec(cfg)]) == FROZEN


@pytest.mark.parametrize("use", ["param_spec", "frozen", "matmuls", "model"])
def test_an_unknown_fusion_names_its_missing_file(use):
    cfg = dict(_cfg("butd_vqa"), fusion="nosuch")
    call = {"param_spec": lambda: params.param_spec(cfg),
            "frozen": lambda: ref.frozen(cfg, []),
            "matmuls": lambda: flops.matmuls(cfg),
            "model": lambda: ref.Model(cfg, {})}[use]
    with pytest.raises(FileNotFoundError, match=r"reference/fusion/nosuch\.py"):
        call()


@pytest.mark.parametrize("name", ["../params", "butd.py", ""])
def test_a_fusion_name_is_a_file_of_the_folder(name):
    with pytest.raises(FileNotFoundError):
        fusion.load(name)


def test_each_configuration_has_its_fusion_file():
    for c in manifest.Manifest().data["configs"]:
        mod = fusion.load(manifest.Manifest().config(c["name"])["fusion"])
        for attr in ("params", "FROZEN", "question", "logits", "matmuls"):
            assert hasattr(mod, attr), (c["name"], attr)


def test_the_fusion_leaves_come_last():
    cfg = _cfg("butd_vqa")
    own = fusion.load("butd").params(cfg)
    assert params.param_spec(cfg)[-len(own):] == own
    assert {n for n, *_ in own} >= {"joint_emb.linear.layers.0.b", "classifier.fc2.v"}
