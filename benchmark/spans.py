"""The program's spans in a cell's traced stretch: ``run.py --trace 1``, with
the stretch's Chrome trace also read for the ``clive2.*`` ranges the
program records while a profiler runs (``clive2_tpu_torch/utils/
profiling.py:span``: the sample, its trace and connect stages, the RNG,
each cast, its sort and the queue's waits).  From the root of a checkout,
on a machine with a CUDA card:

    python3 benchmark/spans.py --workload sponza.1080p --seed 2147483901 --seconds 50

prints ``run.py``'s result line, then one JSON line: the stretch's samples,
its device time (the benchmark's own ray counts left out), the part of it
launched outside every program range, and per span name what
``program_spans`` returns.  Nothing in ``run.py`` reads this file: it is
the arithmetic a ``spans`` key of ``tracing.records`` would hold.

A device operation belongs to the ranges open on the host when it was
launched, matched by the profiler's correlation id, as in ``tracing.py``.
"""

from __future__ import annotations

import json
import os
import sys

PROGRAM = "clive2."               # the prefix of the program's span names


def program_spans(spans, device, gaps):
    """Per ``clive2.*`` name: ``count`` and ``host_s`` (its ranges and their
    summed length), ``device_s`` (device time launched inside any of its
    ranges), ``self_device_s`` and ``self_launches`` (the device operations
    whose innermost range at launch is one of its), and ``idle_s`` (the
    union's gaps whose middle falls where it is the innermost range), in
    seconds.  ``spans`` holds (start, end, name) ranges, which nest as a
    call tree's do; ``device`` (launch time or None, duration); ``gaps``
    (start, end); times in us.  One sweep over the ranges by start and the
    launches and gap middles by time."""
    out = {}
    for a, b, name in spans:
        s = out.setdefault(name, dict(count=0, host_s=0.0, device_s=0.0,
                                      self_device_s=0.0, self_launches=0,
                                      idle_s=0.0))
        s["count"] += 1
        s["host_s"] += (b - a) / 1e6
    marks = sorted([(t, 0, dur) for t, dur in device if t is not None]
                   + [((a + b) / 2, 1, b - a) for a, b in gaps])
    spans = sorted(spans, key=lambda h: (h[0], -h[1]))
    stack, i = [], 0
    for t, is_gap, dur in marks:
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if not stack:
            continue
        inner = out[stack[-1][2]]
        if is_gap:
            inner["idle_s"] += dur / 1e6
            continue
        inner["self_device_s"] += dur / 1e6
        inner["self_launches"] += 1
        for name in {h[2] for h in stack if h[1] >= t}:
            out[name]["device_s"] += dur / 1e6
    return out


def read(path: str) -> dict:
    """The program's spans in the Chrome trace at ``path``: ``device_s``,
    the device's kernels, copies and memsets summed (those launched under
    ``bench.count`` left out, as ``tracing.records`` does), ``outside_s``,
    the part launched outside every ``clive2.*`` range, and ``spans``
    (``program_spans``)."""
    from benchmark import tracing

    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    spans, counts, launch_ts = [], [], {}
    for e in events:
        cat, name = e.get("cat", ""), e["name"]
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" and name.startswith(PROGRAM):
            spans.append((ts, ts + dur, name))
        elif cat == "user_annotation" and name == tracing.COUNT:
            counts.append((ts, ts + dur))
        corr = (e.get("args") or {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_ts[corr] = ts
    device = []
    for e in events:
        if e.get("cat") not in tracing.DEVICE_CATEGORIES:
            continue
        t = launch_ts.get((e.get("args") or {}).get("correlation"))
        if t is not None and any(a <= t <= b for a, b in counts):
            continue
        device.append((t, float(e["ts"]), float(e["dur"])))
    _, gaps = tracing.union([(ts, ts + dur) for _, ts, dur in device])
    by_name = program_spans(spans, [(t, dur) for t, _, dur in device], gaps)
    total = sum(dur for _, _, dur in device) / 1e6
    return dict(device_s=total,
                outside_s=total - sum(s["self_device_s"]
                                      for s in by_name.values()),
                spans=by_name)


def traced(fn):
    """``fn()``, a traced run of the harness, with each trace that
    ``tracing.records`` reads also read by ``read`` (before ``run.py``
    removes it).  Returns (what ``fn`` returns, ``read``'s dict with the
    stretch's ``samples``)."""
    from benchmark import tracing

    got = {}
    records = tracing.records

    def records_and_spans(path, casts, samples, *a, **k):
        got.update(read(path), samples=samples)
        return records(path, casts, samples, *a, **k)

    tracing.records = records_and_spans
    try:
        return fn(), got
    finally:
        tracing.records = records


def main(argv=None) -> int:
    """``run.main`` with ``--trace 1``; prints the spans' line after the
    result's."""
    from benchmark import run

    argv = list(sys.argv[1:] if argv is None else argv)
    rc, got = traced(lambda: run.main(argv + ["--trace", "1"]))
    if rc == 0:
        print(json.dumps(got), flush=True)
    return rc


if __name__ == "__main__":
    if not __package__:                 # run as a file: import as a package
        sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
        from benchmark.spans import main as _main
        sys.exit(_main())
    sys.exit(main())
