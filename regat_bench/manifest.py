"""BENCHMARK.json and the files it names: the harness finds a cell's
configuration, traffic mix, driver, limits and per-layer metric readers by
name, so a later cell, mix or metric is new files and new entries only.

  configs/<config>.json     the configuration, as its `file` names it
  reference/fusion/<fusion>.py
                            the configuration's fusion and classifier, as
                            its "fusion" names them: their leaves, frozen
                            leaves, reference forward and matrix products
  traffic/<mix>.json        a mix's parameters; its "driver" names
  drivers/<driver>.py       the code that runs a mix (`run(ctx)`)
  limits/<workload>.json    each compared number's limit in that cell
  metrics/<metric>.py       a per-layer metric's reader (`read(rec)`)
  pending.json              the cells the benchmark does not run yet: their
                            workloads and new metrics, and under
                            "reported_by" the metrics of BENCHMARK.json each
                            of them reports too (merged in with pending=True)
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)  # the checkout: BENCHMARK.json's paths start here


def load_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


class Manifest:
    def __init__(self, path: str = os.path.join(ROOT, "BENCHMARK.json"), pending: bool = False):
        self.path = os.path.abspath(path)
        self.data = load_json(self.path)
        if pending:
            self._merge(load_json(os.path.join(HERE, "pending.json")))

    def _merge(self, delta: dict) -> None:
        for section in ("workloads", "end_to_end", "per_layer"):
            self.data[section] = self.data[section] + delta.get(section, [])
        for cell, names in delta.get("reported_by", {}).items():
            for section in ("end_to_end", "per_layer"):
                self.data[section] = [
                    dict(m, workloads=m["workloads"] + [cell])
                    if m["name"] in names and "workloads" in m else m
                    for m in self.data[section]]

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return load_json(os.path.join(ROOT, c["file"]))
        raise KeyError(f"no config {name!r} in {self.path}")

    def metrics_for(self, section: str, workload: str) -> List[dict]:
        """The metrics of `section` ("end_to_end" or "per_layer") that the
        cell reports: those that list it, and those that list no cell."""
        return [m for m in self.data[section]
                if "workloads" not in m or workload in m["workloads"]]


def traffic(mix: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", mix + ".json"))


def limits(workload: str) -> Dict[str, float]:
    return load_json(os.path.join(HERE, "limits", workload + ".json"))


def _module(kind: str, name: str) -> ModuleType:
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"{kind} {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        f"regat_bench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str) -> ModuleType:
    return _module("drivers", name)


def reader(metric: str) -> ModuleType:
    return _module("metrics", metric)


def read_metrics(metrics: List[dict], rec: Any) -> Dict[str, dict]:
    """Each per-layer metric its reader finds something to read for; a
    reader that returns None leaves its metric out."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
