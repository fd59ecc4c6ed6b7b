"""Find a cell and everything that belongs to it by name.

``BENCHMARK.json`` at the checkout's root lists configurations, cells
(``workloads``) and metrics.  A configuration's file is the one its
entry names; a cell's traffic is ``portbench/traffic/<traffic>.json``,
its limits ``portbench/limits/<cell>.json``; a per-layer metric's
reader is ``portbench/metrics/<name>.py``.  A later change adds a cell,
a configuration, a traffic mix or a metric by adding files and entries,
never by editing one that is there."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # metric entries this cell reports with --trace 1


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def _in_cell(metric: dict, cell: str, default: bool) -> bool:
    return cell in metric["workloads"] if "workloads" in metric else default


def find(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError when absent."""
    b = benchmark(root)
    w = next((w for w in b["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in b["configs"] if c["name"] == w["config"])
    e2e = [m for m in b["end_to_end"] if _in_cell(m, name, True)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in b["per_layer"] if _in_cell(m, name, m["moves"] in e2e_names)]
    return Cell(
        name=name,
        config_name=w["config"],
        config=_load(os.path.join(root, cfg_entry["file"])),
        traffic_name=w["traffic"],
        traffic=_load(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_load(os.path.join(HERE, "limits", name + ".json")),
        chips=int(w["chips"]),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def metric_reader(name: str):
    """The ``read(ctx)`` function of ``portbench/metrics/<name>.py``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
