"""The program's spans read from a traced stretch (``benchmark/spans.py``):
each figure of nested spans by hand on a synthetic Chrome trace, the
existing records unmoved by the program's ranges, and a traced run of a
small cell on the CPU."""

import json

import pytest

from benchmark import spans, tracing
from benchmark.tests.helpers import run_small, small_cell
from benchmark.tests.test_tracing import _trace, _x


def _by_hand(tmp_path):
    """Nested spans, two ranges of one name, a range that ends where the
    next begins, an op under ``bench.count`` and one inside no span."""
    ev, corr = [], iter(range(1, 100))

    def op(t, start, dur):
        c = next(corr)
        ev.extend([_x("cudaLaunchKernel", "cuda_runtime", t, 0.5, corr=c),
                   _x(f"k{c}", "kernel", start, dur, tid=7, corr=c)])

    for name, a, dur in [
            ("bench.sample", 0, 200), ("clive2.sample", 1, 198),
            ("clive2.rng", 2, 4), ("bench.count", 7, 2),
            ("clive2.trace", 10, 90), ("clive2.cast", 30, 30),
            ("clive2.cast.sort", 31, 4), ("clive2.wait", 45, 13),
            ("clive2.cast.sort", 58, 1.5), ("clive2.rng", 70, 2),
            ("clive2.connect", 110, 80), ("clive2.cast", 120, 30)]:
        ev.append(_x(name, "user_annotation", a, dur))
    op(3, 10, 5)        # clive2.rng
    op(8, 16, 2)        # bench.count: left out
    op(11, 20, 20)      # clive2.trace
    op(32, 41, 4)       # clive2.cast.sort
    op(40, 50, 30)      # clive2.cast
    op(59, 85, 3)       # the second clive2.cast.sort, not clive2.wait
    op(71, 90, 2)       # clive2.rng
    op(121, 130, 40)    # clive2.cast in clive2.connect
    op(160, 175, 10)    # clive2.connect
    op(195, 196, 2)     # clive2.sample
    op(210, 212, 2)     # no span
    path = tmp_path / "spans.json"
    path.write_text(json.dumps(dict(traceEvents=ev)))
    return str(path)


def test_nested_spans_by_hand(tmp_path):
    got = spans.read(_by_hand(tmp_path))
    # gaps of the union, by the innermost span at their middle: 15..20,
    # 80..85, 88..90 clive2.trace; 40..41 clive2.cast; 45..50 clive2.wait;
    # 92..130, 170..175 clive2.connect; 185..196 clive2.sample; 198..212
    # none
    want = {  # count, host, device, self device, self launches, idle (us)
        "clive2.sample": (1, 198, 116, 2, 1, 11),
        "clive2.rng": (2, 6, 7, 7, 2, 0),
        "clive2.trace": (1, 90, 59, 20, 1, 12),
        "clive2.cast": (2, 60, 77, 70, 2, 1),
        "clive2.cast.sort": (2, 5.5, 7, 7, 2, 0),
        "clive2.wait": (1, 13, 0, 0, 0, 5),
        "clive2.connect": (1, 80, 50, 10, 1, 43),
    }
    assert set(got["spans"]) == set(want)
    us = lambda v: pytest.approx(v * 1e-6)
    for name, (n, host, dev, own, launches, idle) in want.items():
        assert got["spans"][name] == dict(
            count=n, host_s=us(host), device_s=us(dev),
            self_device_s=us(own), self_launches=launches,
            idle_s=us(idle)), name
    # every op but the count's once: the spans' self time and the op
    # outside them
    assert got["device_s"] == us(118) and got["outside_s"] == us(2)
    r = tracing.records(_by_hand(tmp_path), [], samples=1,
                        scene_build_s=0.0, n_triangles=0)
    assert r["launches"] == 10 and r["busy_s"] == us(118)


def test_records_unmoved_by_the_program_spans(tmp_path):
    """``tracing.records`` on a trace with the program's ranges added, as
    the program nests them (the benchmark's ``bench.cast`` around
    ``clive2.cast``): every record as without them, but the idle gaps
    named by the innermost range, which may now be a program span."""
    plain = tracing.records(_trace(tmp_path), [], samples=1,
                            scene_build_s=0.0, n_triangles=16)
    path = _trace(tmp_path)
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    ev += [_x("clive2.sample", "user_annotation", 1, 98),
           _x("clive2.trace", "user_annotation", 9, 36),
           _x("clive2.cast", "user_annotation", 10.5, 29),
           _x("clive2.cast.sort", "user_annotation", 11, 2),
           _x("clive2.rng", "user_annotation", 50, 2)]
    with open(path, "w") as f:
        json.dump(dict(traceEvents=ev), f)
    got = tracing.records(path, [], samples=1, scene_build_s=0.0,
                          n_triangles=16)
    gaps = got.pop("idle_gaps"), plain.pop("idle_gaps")
    assert got == plain
    assert dict(gaps[0]) == {"clive2.cast": pytest.approx(2e-6),
                             "clive2.sample": pytest.approx(15e-6)}
    s = spans.read(path)["spans"]
    assert s["clive2.cast"]["device_s"] == pytest.approx(18e-6)
    assert s["clive2.rng"]["self_device_s"] == pytest.approx(20e-6)
    assert s["clive2.sample"]["self_device_s"] == pytest.approx(10e-6)


def test_a_traced_cell_on_the_cpu(tmp_path):
    """The harness's traced run with the spans read: its result as before,
    and the program's tree: a sample, a trace and a connect per sample, the
    casts the benchmark's wrapper counted, no device time on the CPU."""
    r, got = spans.traced(lambda: run_small(small_cell(trace_samples=2),
                                            tmp_path, seconds=1.0, trace=1))
    assert r["correct"] is True
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert got["samples"] == 2 and got["device_s"] == 0
    s = got["spans"]
    for name in ("clive2.sample", "clive2.trace", "clive2.connect"):
        assert s[name]["count"] == 2, name
    assert s["clive2.cast"]["count"] > 2 and s["clive2.rng"]["count"] > 2
    assert s["clive2.sample"]["host_s"] > s["clive2.trace"]["host_s"] > 0
    assert "clive2.wait" not in s and "clive2.cast.sort" not in s
