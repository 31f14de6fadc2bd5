"""The traced stretch's arithmetic on a synthetic Chrome trace: the union
of device intervals, the launches and casts tied to their host ranges by
correlation id, the idle gaps by the host operation open in them, and the
bytes bound."""

import json

import pytest

from benchmark import manifest, roofline, tracing
from benchmark.peaks import H100_SXM


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, pid=1, tid=tid)
    if corr is not None:
        e["args"] = dict(correlation=corr)
    return e


def _trace(tmp_path):
    ev = [
        _x("bench.sample", "user_annotation", 0, 100),
        _x("bench.count", "user_annotation", 5, 3),
        _x("cudaLaunchKernel", "cuda_runtime", 6, 1, corr=1),
        _x("bench.cast", "user_annotation", 10, 30),
        _x("aten::sort", "cpu_op", 11, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 12, 1, corr=2),
        _x("cudaLaunchKernel", "cuda_runtime", 28, 1, corr=3),
        _x("aten::add", "cpu_op", 50, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 51, 1, corr=4),
        _x("cudaMemcpyAsync", "cuda_runtime", 60, 1, corr=5),
        # the device: a count kernel (left out), two cast kernels, an add
        # and a copy overlapping it
        _x("count_k", "kernel", 7, 2, tid=7, corr=1),
        _x("sort_k", "kernel", 20, 10, tid=7, corr=2),
        _x("walk_k", "kernel", 32, 8, tid=7, corr=3),
        _x("add_k", "kernel", 55, 20, tid=7, corr=4),
        _x("Memcpy DtoH", "gpu_memcpy", 70, 10, tid=7, corr=5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    return str(path)


def test_records(tmp_path):
    casts = [dict(rays=100, active=40, t_max=False),
             dict(rays=10, active=10, t_max=True)]
    r = tracing.records(_trace(tmp_path), casts, samples=1,
                        scene_build_s=1.5, n_triangles=16)
    assert r["launches"] == 4
    assert r["cast_device_s"] == pytest.approx(18e-6)
    # union: [20, 30] + [32, 40] + [55, 80]
    assert r["busy_s"] == pytest.approx(43e-6)
    assert r["window_s"] == pytest.approx(80e-6)
    names = dict(r["idle_gaps"])
    assert names["bench.cast"] == pytest.approx(2e-6)     # 30..32
    assert names["bench.sample"] == pytest.approx(15e-6)  # 40..55
    assert dict(r["device_ops"])["add_k"] == pytest.approx(20e-6)
    rec = dict(trace=r, scene_build_s=1.5)
    read = lambda n: manifest.load_metric(n).read(rec)
    assert read("launches_per_sample") == 4
    assert read("cast_ms_per_sample") == pytest.approx(0.018)
    assert read("device_idle_share") == pytest.approx(100 * (1 - 43 / 80))
    assert read("scene_build_s") == 1.5
    want = (40 * 24 + 100 * 17 + 16 * 36) + (10 * 28 + 10 * 17 + 16 * 36)
    assert sum(roofline.cast_bytes(c["rays"], c["active"], c["t_max"], 16)
               for c in casts) == want
    assert read("cast_roofline") == pytest.approx(
        100 * want / H100_SXM["hbm_bytes_per_s"] / 18e-6)


def test_union_and_gaps():
    busy, gaps = tracing.union([(5, 7), (0, 2), (1, 3), (6, 9)])
    assert busy == 7 and gaps == [(3, 5)]


def test_gap_labels_take_the_innermost_open_range():
    host = [(0, 100, "outer"), (10, 40, "mid"), (20, 30, "inner")]
    gaps = [(24, 26), (34, 36), (60, 62), (200, 210)]
    assert tracing.label_gaps(host, gaps) == ["inner", "mid", "outer",
                                              "host idle"]


def test_readers_read_nothing_from_nothing():
    for m in M_ALL:
        assert manifest.load_metric(m).read({}) is None


M_ALL = [m["name"] for m in manifest.load_manifest()["per_layer"]
         if m["name"] != "scene_build_s"] + [
    m["name"] for m in manifest.load_manifest()["end_to_end"]
    if m["name"] != "setup_s"]


def test_window_readers():
    rec = dict(window=dict(seconds=10.0, samples=20, peak_bytes=2 ** 31,
                           intervals=[0.5] * 18 + [0.9, 1.0]),
               setup_s=12.0)
    read = lambda n: manifest.load_metric(n).read(rec)
    assert read("s_per_sample") == 0.5
    assert read("sample_p90_s") == 0.5          # rank 18 of 20
    assert read("peak_mem_gib") == 2.0
    assert read("setup_s") == 12.0
