"""``BENCHMARK.json`` and the files it names: every configuration, traffic
mix, mode and metric is found by its name, the manifest keeps the
contract's shapes, and a new cell, configuration, traffic mix and metric
are taken as added files and entries with no file that is there edited."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import manifest

M = manifest.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("w", [w["name"] for w in M["workloads"]])
def test_cells_are_found_by_name(w):
    c = manifest.cell(M, w)
    assert c["config"]["name"] == c["workload"]["config"]
    assert manifest.load_mode(c["traffic"]["mode"]).UNIT == "sample"
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(manifest.load_metric(m["name"]).read)
    assert "setup_s" in {m["name"] for m in c["end_to_end"]}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        manifest.cell(M, "no.such.cell")
    with pytest.raises(FileNotFoundError):
        manifest.load_metric("no_such_metric")


def test_manifest_shapes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in M[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in M["end_to_end"]}
    layers = {}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        layers.setdefault(m["name"], m["layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for conf in M["configs"]:
        path = os.path.join(manifest.ROOT, conf["file"])
        assert conf["file"].startswith("benchmark/") and os.path.exists(path)
        with open(path) as f:
            body = json.load(f)
        assert body["reduced"] == conf["reduced"]
    for w in M["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert M["paths"] == ["benchmark"]
    assert len(json.dumps(M)) < 64 * 1024


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_a_new_cell_is_files_and_entries(tmp_path):
    """In a copy of the benchmark: a configuration, a traffic mix, a metric
    and a cell added as new files and manifest entries run through the
    harness on the CPU, and no file that was there changed."""
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(manifest.ROOT, "benchmark"),
                    copy / "benchmark",
                    ignore=shutil.ignore_patterns("_work", "__pycache__"))
    before = _digests(copy / "benchmark")
    m = json.loads(json.dumps(M))
    cfg = json.load(open(copy / "benchmark" / "configs" / "cornell.json"))
    cfg = dict(cfg, name="cornell_b")
    (copy / "benchmark" / "configs" / "cornell_b.json").write_text(
        json.dumps(cfg))
    tr = json.load(open(copy / "benchmark" / "traffic"
                        / "progressive_720p.json"))
    (copy / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(
        dict(tr, width=24, height=16, why="a tiny mix")))
    (copy / "benchmark" / "metrics" / "samples_in_window.py").write_text(
        "def read(records):\n"
        "    w = records.get('window')\n"
        "    return w['samples'] if w else None\n")
    m["configs"].append(dict(name="cornell_b", source="a test",
                             file="benchmark/configs/cornell_b.json",
                             reduced=[], why="a test"))
    m["workloads"].append(dict(name="cornell_b.tiny", config="cornell_b",
                               traffic="tiny", chips=1, why="a test"))
    m["end_to_end"].append(dict(name="samples_in_window", unit="samples",
                                better="higher", bound=0.05,
                                source="host_clock",
                                workloads=["cornell_b.tiny"]))
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    code = (
        "import json, argparse, sys\n"
        "from benchmark import manifest, run\n"
        "c = manifest.cell(manifest.load_manifest(), 'cornell_b.tiny')\n"
        "a = argparse.Namespace(workload='cornell_b.tiny', seed=7,"
        " seconds=0.5, trace=0)\n"
        "r = run.run(c, a, device='cpu', resources=sys.argv[1])\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(copy), manifest.ROOT]))
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path / "res")],
                         cwd=str(copy), env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["samples_in_window"]["value"] >= 1
    assert "s_per_sample" in result["metrics"]
    after = _digests(copy / "benchmark")
    assert {k: after[k] for k in before} == before
