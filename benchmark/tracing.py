"""The ``--trace 1`` run's records: a ``torch.profiler`` trace of a short
steady stretch of the window, reduced to the numbers the per-layer readers
take (``metrics/``), and the line's ``breakdown``.

Spans come from the benchmark's own files: while the stretch is traced,
every ``intersect_scene`` call of the integrator runs inside a
``bench.cast`` range (the names ``integrator/trace.py`` and
``integrator/connect.py`` import are wrapped; the program is not edited),
and each sample inside a ``bench.sample`` range.  A device kernel, copy or
memset belongs to the range in which the host launched it, matched by the
profiler's correlation id.  The wrapper counts each cast's rays on the
device under a ``bench.count`` range, whose kernels are left out of every
reading.

The union of the device's intervals is a copy of the arithmetic of
``clive2_tpu_torch/utils/profiling.py:device_busy``.
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CAST, SAMPLE, COUNT = "bench.cast", "bench.sample", "bench.count"


class CastSpans:
    """Wraps the integrator's ``intersect_scene`` while ``on``: a
    ``bench.cast`` range around each call, and per call the rays, the
    active rays (a device count) and whether it carried ``t_max``."""

    def __init__(self):
        self.on = False
        self.casts = []
        self._saved = []

    def install(self):
        from clive2_tpu_torch.integrator import connect, trace

        for mod in (trace, connect):
            orig = mod.intersect_scene
            self._saved.append((mod, orig))
            mod.intersect_scene = self._wrap(orig)

    def uninstall(self):
        for mod, orig in self._saved:
            mod.intersect_scene = orig
        self._saved = []

    def _wrap(self, orig):
        def intersect_scene(origin, direction, scene, active=None,
                            t_max=None, **kw):
            if not self.on:
                return orig(origin, direction, scene, active=active,
                            t_max=t_max, **kw)
            with torch.profiler.record_function(COUNT):
                n_active = (active.sum() if active is not None
                            else torch.tensor(origin.shape[0]))
            self.casts.append(dict(rays=int(origin.shape[0]),
                                   active=n_active,
                                   t_max=t_max is not None))
            with torch.profiler.record_function(CAST):
                return orig(origin, direction, scene, active=active,
                            t_max=t_max, **kw)
        return intersect_scene


def _activities(cuda: bool):
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])


def warm_profiler(cuda: bool = True):
    """Start and stop the profiler once in set-up, so that the stretch does
    not pay its first start."""
    from torch.profiler import profile

    with profile(activities=_activities(cuda)):
        torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
        if cuda:
            torch.cuda.synchronize()


@contextlib.contextmanager
def profiled(path: str, cuda: bool = True):
    """Profile the block (host, and the device with ``cuda``) and write its
    Chrome trace to ``path``."""
    from torch.profiler import profile

    with profile(activities=_activities(cuda)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def union(spans):
    """Total length of the union of (start, end) spans, and the gaps between
    them as (start, end)."""
    busy, end, gaps = 0.0, None, []
    for a, b in sorted(spans):
        if end is None:
            busy += b - a
            end = b
        elif b > end:
            if a > end:
                gaps.append((end, a))
            busy += b - max(a, end)
            end = b
    return busy, gaps


def label_gaps(host, gaps):
    """Per gap (start, end), the name of the innermost host range open at
    its middle, or ``host idle``.  ``host`` holds one thread's ranges as
    (start, end, name), which nest, as a call tree's do."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    mids = sorted(((a + b) / 2, k) for k, (a, b) in enumerate(gaps))
    out = [None] * len(gaps)
    stack, i = [], 0
    for t, k in mids:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[k] = stack[-1][2] if stack else "host idle"
    return out


def records(path: str, casts, samples: int, scene_build_s: float,
            n_triangles: int) -> dict:
    """The traced stretch's records, from the Chrome trace at ``path``:
    times in seconds.  ``casts`` are ``CastSpans.casts`` with their counts
    read back."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    ranges = {CAST: [], SAMPLE: [], COUNT: []}
    launch_ts = {}
    main = None
    for e in events:
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" and e["name"] in ranges:
            ranges[e["name"]].append((ts, ts + dur))
            main = e.get("tid")
        corr = (e.get("args") or {}).get("correlation")
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_ts[corr] = ts
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("tid") == main and e.get("cat") in (
                "cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")]

    def inside(kind, t):
        return any(a <= t <= b for a, b in ranges[kind])

    device = []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        corr = (e.get("args") or {}).get("correlation")
        t_launch = launch_ts.get(corr)
        if t_launch is not None and inside(COUNT, t_launch):
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        device.append(dict(name=e["name"], cat=e["cat"], start=ts,
                           end=ts + dur,
                           cast=t_launch is not None
                           and inside(CAST, t_launch)))
    busy, gaps = union([(d["start"], d["end"]) for d in device])
    if ranges[SAMPLE] and device:
        start = min(a for a, _ in ranges[SAMPLE])
        stop = max(d["end"] for d in device)
        window = stop - start
    else:
        window = 0.0
    by_name = {}
    for d in device:
        by_name[d["name"]] = by_name.get(d["name"], 0.0) + (
            d["end"] - d["start"])
    gap_by = {}
    for (a, b), name in zip(gaps, label_gaps(host, gaps)):
        gap_by[name] = gap_by.get(name, 0.0) + (b - a)
    top = lambda d: [[k, v / 1e6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return dict(
        samples=samples,
        launches=len(device),
        cast_device_s=sum(d["end"] - d["start"] for d in device
                          if d["cast"]) / 1e6,
        casts=casts,
        n_triangles=n_triangles,
        busy_s=busy / 1e6,
        window_s=window / 1e6,
        scene_build_s=scene_build_s,
        device_ops=top(by_name),
        idle_gaps=top(gap_by),
    )


def remove(path: str):
    with contextlib.suppress(FileNotFoundError):
        os.remove(path)
