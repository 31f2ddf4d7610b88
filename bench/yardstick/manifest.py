"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
the configuration's file is the one ``configs`` gives, the mix is
``bench/traffic/<traffic>.json``, a per-layer metric's reader is
``bench/metrics/<name>.py`` and a cell's limits are
``bench/limits/<workload>.json``.  Adding a cell, a mix or a metric adds
files and entries; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


@dataclass(frozen=True)
class Cell:
    root: Path
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self) -> list[dict]:
        return [m for m in self.manifest["end_to_end"] if reports(m, self.name)]

    def per_layer(self) -> list[dict]:
        return [m for m in self.manifest["per_layer"]
                if reports(m, self.name, self.manifest)]


def reports(metric: dict, workload: str, manifest: dict | None = None) -> bool:
    """Whether ``workload`` reports ``metric``: the cells its ``workloads``
    lists, or without the key every cell that reports the end-to-end metric
    it ``moves`` (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    if manifest is None or "moves" not in metric:
        return True
    target = next(m for m in manifest["end_to_end"]
                  if m["name"] == metric["moves"])
    return reports(target, workload)


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def bench_dir(root: Path) -> Path:
    return root / "bench"


def load_cell(root: Path, workload: str) -> Cell:
    man = load_manifest(root)
    wl = next((w for w in man["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"known: {[w['name'] for w in man['workloads']]}")
    cfg_entry = next(c for c in man["configs"] if c["name"] == wl["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (bench_dir(root) / "traffic" / f"{wl['traffic']}.json").read_text())
    lim_path = bench_dir(root) / "limits" / f"{workload}.json"
    limits = json.loads(lim_path.read_text()) if lim_path.exists() else {}
    return Cell(root, man, wl, config, traffic, limits)


def load_reader(root: Path, metric: str):
    """The module ``bench/metrics/<metric>.py`` (its ``read`` and, where it
    has one, ``install``)."""
    path = bench_dir(root) / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
