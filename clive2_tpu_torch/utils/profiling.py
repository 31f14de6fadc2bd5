"""Profiling and tracing utilities (port of clive2_tpu/utils/profiling.py).

  * ``span``: the program's spans, ``clive2.<name>`` ranges that a running
    ``torch.profiler`` records on its own clock, beside the device work
    launched inside them, and nothing when no profiler runs; ``spanned``
    puts a function's body in one.  The twelve names and their sites:
    ``sample`` (``Renderer.run_sample``, ``run_adaptive_sample``),
    ``trace`` (``integrator/render.py:trace_wavefront``), ``trace.shade``
    (each bounce's shading in ``integrator/trace.py:trace_subpaths``),
    ``connect`` (``integrator/connect.py:connect_paths``), ``rng``
    (every draw, split and fold: on the card ``rng.uniform_kernel`` and
    ``rng.keys_kernel``, on the CPU ``rng.threefry2x32``), ``cast``
    (``ops/intersect.py:intersect_scene``), ``cast.sort`` (its Morton sort
    and gathers, and its unsort), ``wait`` (each round read of
    ``ops/traverse_stream2.py:queued_cast``), and the movie's frame
    boundary in ``apps/movie.py:Movie.step``: ``frame`` (the whole
    boundary; the movie CLI ends its frames before it), holding
    ``frame.image`` (``Movie.end_frame``: the renderer's ``block`` and its
    tone-mapped ``image``, read back), ``frame.save`` (the PNG's encode
    and write) and ``frame.camera`` (``Movie.begin_frame``:
    ``orbit_camera``, ``with_camera`` and the frame's new ``Renderer``);
  * ``count``: the program's counters, device totals added while a
    profiler records and nothing otherwise, read with ``counts``.  The
    names and their sites: ``trace.vertices`` (the stored subpath
    vertices of ``trace_subpaths``) and ``trace.specular_vertices``
    (those on a specular material, ``integrator/trace.py:specular``);
  * ``trace_to``: a ``torch.profiler`` trace of the enclosed region, written
    as a Chrome trace (open it in Perfetto or chrome://tracing), and
    ``device_busy``, the card's busy share read from such a trace;
  * ``timed``: the reference's wall-clock decorator (``constants.timed``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import os

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

from ..constants import timed  # noqa: F401  (re-export, as the JAX package)

TRACE_FILE = "trace.json"
# what the card does in a Chrome trace of torch.profiler
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "clive2."
_OFF = contextlib.nullcontext()
# the counters' device totals by name, made by the first ``count`` of a
# name while a profiler records and emptied by ``counts``
_COUNTS = {}


def span(name: str):
    """A ``clive2.<name>`` range (``torch.profiler.record_function``) while
    a profiler records, else one shared null context: a span costs a flag
    read when no profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(SPAN_PREFIX + name)
    return _OFF


def count(name: str, value):
    """Add ``value`` (a device scalar, or a function that makes one) into
    the device total of counter ``name`` while a profiler records, with no
    host sync; else nothing: a flag read, no launch and no tensor (a
    function is not called)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    value = value() if callable(value) else value
    total = _COUNTS.get(name)
    if total is None:
        _COUNTS[name] = value.to(torch.int64, copy=True)
    else:
        total.add_(value)


def counts() -> dict:
    """The counters' totals since the last call, {name: int}, read with
    one sync, and cleared."""
    names = sorted(_COUNTS)
    if not names:
        return {}
    totals = torch.stack([_COUNTS.pop(k) for k in names])
    return dict(zip(names, totals.tolist()))


def spanned(name: str):
    """Decorate a function so that each call runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)
        return inner
    return wrap


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` (the CPU, and the
    card when there is one) and write its Chrome trace to
    ``logdir/trace.json``.  Yields the profiler, whose ``key_averages()``
    can be read after the block."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        yield prof
        for i in range(torch.cuda.device_count() if cuda else 0):
            torch.cuda.synchronize(i)
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def device_busy(logdir: str):
    """The card's activity in ``trace_to``'s trace in ``logdir``: the union
    of its kernels', copies' and memsets' intervals (``busy_ms``) over the
    trace's span from its first event to its last (``window_ms``), their
    ratio (``share``) and the number of device events."""
    with open(os.path.join(logdir, TRACE_FILE)) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        raise ValueError(f"{logdir}: the trace holds no timed events")
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") in DEVICE_CATEGORIES)
    busy, end = 0.0, float("-inf")
    for a, b in spans:                 # union of the device intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    start = min(float(e["ts"]) for e in events)
    stop = max(float(e["ts"]) + float(e["dur"]) for e in events)
    window = stop - start
    return dict(busy_ms=busy / 1e3, window_ms=window / 1e3,
                share=busy / window if window > 0 else 0.0,
                device_events=len(spans))

