"""Finds what a cell is made of, by the names in ``BENCHMARK.json``: its
configuration (``configs/<name>.json``, the file the manifest names), its
traffic mix (``traffic/<name>.json``), the traffic's mode
(``modes/<mode>.py``) and each metric's reader (``metrics/<name>.py``).
A later cell, mix, mode or metric is a file and an entry; no file here
changes for it."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_module(kind: str, name: str, here: str = HERE):
    path = os.path.join(here, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_mode(name: str, here: str = HERE):
    return _load_module("modes", name, here)


def load_metric(name: str, here: str = HERE):
    """The reader of metric ``name``: a module with ``read(records)``,
    which returns the metric's value or None when the records hold nothing
    to read it from."""
    return _load_module("metrics", name, here)


def cell(manifest: dict, workload: str, root: str = ROOT) -> dict:
    """Everything a run of ``workload`` needs: the cell's entry, its
    configuration and traffic (parsed), and the end-to-end and per-layer
    metrics it reports."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"there are {sorted(cells)}")
    entry = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    conf_entry = configs[entry["config"]]
    with open(os.path.join(root, conf_entry["file"])) as f:
        config = json.load(f)
    traffic_path = os.path.join(root, "benchmark", "traffic",
                                f"{entry['traffic']}.json")
    with open(traffic_path) as f:
        traffic = json.load(f)
    applies = lambda m: workload in m.get("workloads", [workload])
    return dict(
        workload=entry, config=config, config_entry=conf_entry,
        traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m for m in manifest["per_layer"] if applies(m)],
    )
