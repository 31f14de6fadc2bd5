"""Profiling and tracing utilities (port of clive2_tpu/utils/profiling.py).

  * ``stage_timer``: a wall-clock context manager that waits for the card
    before it reads the clock, so that a time under asynchronous launches
    means what it says;
  * ``trace_to``: a ``torch.profiler`` trace of the enclosed region, written
    as a Chrome trace (open it in Perfetto or chrome://tracing), and
    ``device_busy``, the card's busy share read from such a trace;
  * ``device_memory_stats``: ``torch.cuda.memory_stats`` per card;
  * ``timed``: the reference's wall-clock decorator (``constants.timed``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from ..constants import timed  # noqa: F401  (re-export, as the JAX package)

TRACE_FILE = "trace.json"
# what the card does in a Chrome trace of torch.profiler
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _synchronize(sync):
    """Wait for ``sync`` (a tensor or a device) or, when None, every card."""
    if sync is None:
        if torch.cuda.is_available():
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)
        return
    device = sync.device if isinstance(sync, torch.Tensor) else \
        torch.device(sync)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage_timer(name: str, result_holder: dict | None = None, sync=None):
    """Time a pipeline stage: after the block, wait for ``sync`` (a tensor
    or a device; every card when None), then add the seconds to
    ``result_holder[name]``, or print them when no holder is given."""
    t0 = time.perf_counter()
    yield
    _synchronize(sync)
    dt = time.perf_counter() - t0
    if result_holder is not None:
        result_holder[name] = result_holder.get(name, 0.0) + dt
    else:
        print(f"[stage {name}] {dt:.4f}s")


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
        _synchronize(None)
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


def device_memory_stats():
    """``torch.cuda.memory_stats`` of each card by device name; the CPU's
    entry is an empty dict."""
    if not torch.cuda.is_available():
        return {"cpu": {}}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
