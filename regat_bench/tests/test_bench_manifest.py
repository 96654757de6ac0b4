"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import os
import re

import pytest

from regat_bench import manifest
from regat_bench.reference import fusion

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = ("hid", "dim", "rank", "head", "width", "size", "expansion")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["regat_bench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = set()
    for section, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                          ("workloads", {"name", "config", "traffic", "chips", "why"}),
                          ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                          ("per_layer", {"name", "unit", "better", "source", "layer",
                                         "moves"})):
        for e in bench[section]:
            assert set(e) - {"workloads"} == keys, (section, e)
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in bench["end_to_end"])


def test_cells_report_enough(bench):
    man = manifest.Manifest(os.path.join(ROOT, "BENCHMARK.json"))
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for w in bench["workloads"]:
        e2e = [m["name"] for m in man.metrics_for("end_to_end", w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.metrics_for("per_layer", w["name"])
        assert w["chips"] in (1, 4)
    e2e_names = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e_names
        for c in m.get("workloads", []):
            assert c in cells
            assert m["moves"] in [x["name"] for x in man.metrics_for("end_to_end", c)]


def test_files_found_by_name(bench):
    man = manifest.Manifest(os.path.join(ROOT, "BENCHMARK.json"))
    for c in bench["configs"]:
        assert c["file"].startswith("regat_bench/configs/")
        cfg = man.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not any(w in k for w in WIDTHS)
        assert callable(fusion.load(cfg["fusion"]).logits)
    for w in bench["workloads"]:
        mix = manifest.traffic(w["traffic"])
        assert callable(manifest.driver(mix["driver"]).run)
        assert manifest.limits(w["name"])
    for m in bench["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_metrics_for_filters_by_cell(bench):
    man = manifest.Manifest(os.path.join(ROOT, "BENCHMARK.json"))
    for w in bench["workloads"]:
        for m in man.metrics_for("per_layer", w["name"]):
            assert "workloads" not in m or w["name"] in m["workloads"]
