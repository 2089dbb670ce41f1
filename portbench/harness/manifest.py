"""The benchmark's manifest and the files it names.

``BENCHMARK.json`` at the checkout's root lists configurations, cells and
metrics by name; everything that belongs to one of them is a file of its
own under ``portbench/``, found here by that name:

- ``configs/<config>.json``: the configuration's sizes and limits;
- ``configs/<config>.py``: builds the system under test from those sizes;
- ``reference/<config>.py``: the plain reference of the same outputs;
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

A later cell, configuration or metric is added as new files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_module(path: Path, tag: str):
    """Import the file at ``path`` as a module of its own (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"portbench: no file {path}")
    name = "portbench_" + tag + "_" + re.sub(r"[^A-Za-z0-9_]", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of the manifest, with every file it names loaded."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    system_module: object
    reference_module: object
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def read_manifest(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or unlisted and
    moving an end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell named ``workload`` of ``root/BENCHMARK.json``."""
    manifest = read_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"portbench: no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    for key in ("config", "traffic"):
        if not NAME_RE.match(w[key]):
            raise ValueError(f"portbench: bad {key} name {w[key]!r}")
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"] if _applies(m, workload, reported)]
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=config,
        traffic=traffic,
        system_module=load_module(bench_dir / "configs" / f"{w['config']}.py", "config"),
        reference_module=load_module(bench_dir / "reference" / f"{w['config']}.py", "reference"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def load_reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The reader module of the per-layer metric ``metric``."""
    if not NAME_RE.match(metric):
        raise ValueError(f"portbench: bad metric name {metric!r}")
    return load_module(bench_dir / "metrics" / f"{metric}.py", "metric")
