"""Host-to-card health probe (the counterpart of the JAX package's
scripts/link_probe.py).

Times, in the script's order, each phase a run passes through, so that a
hang or a slowdown can be placed instead of guessed at:

  attach              CUDA initialisation and the first device query
  h2d/d2h             copies of 1 MB and 32 MB from and to pageable numpy
  dispatch_x20        round trip of a trivial op (launch + synchronise), x20
  first_small_program the first call of a @ a + sin(a).sum() on a bf16
                      512x512 (the libraries' and kernels' first loads)
  kernel_first_run    the port's kernel library loaded (built by nvcc when
                      its sources' hash misses: ``built``, ``nvcc_seconds``)
                      and the probe kernel's first launch
  kernel_steady       the probe kernel's second run

One JSON line per phase, then a ``verdict`` line with the script's rule
and thresholds (link_probe.py:101-109): degraded-transfer, -compile or
-latency, else healthy.  ``PHASES`` maps each phase to the script's name.

    python -m clive2_tpu_torch.scripts.link_probe [--device cuda|cpu]

On the CPU the copies are host copies and the probe kernel is its plain
version: a check that the probe runs, not a measurement of a link.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops.link_probe import scale_shift

# the port's phase: the script's phase it times the counterpart of
PHASES = {
    "attach": "attach",
    "h2d_1mb": "h2d_1mb",
    "d2h_1mb": "d2h_1mb",
    "h2d_32mb": "h2d_32mb",
    "d2h_32mb": "d2h_32mb",
    "dispatch_x20": "dispatch_x20",
    "first_small_program": "xla_compile_small",
    "kernel_first_run": "pallas_compile_first_run",
    "kernel_steady": "pallas_steady",
}
SHAPE = (256, 128)      # the script's probe array, f32


def verdict(rows) -> str:
    """The script's rule (link_probe.py:101-109) on rows named as the
    port's phases (``PHASES``)."""
    by = {r["phase"]: r for r in rows}
    if by.get("h2d_32mb", {}).get("mbps", 1e9) < 50:
        return "degraded-transfer"
    if by.get("kernel_first_run", {}).get("seconds", 0) > 30 or \
            by.get("first_small_program", {}).get("seconds", 0) > 20:
        return "degraded-compile"
    if by.get("dispatch_x20", {}).get("ms_per_call", 0) > 50:
        return "degraded-latency"
    return "healthy"


def probe(device="cuda", out=print):
    """Run every phase on ``device``; print one JSON line each and the
    verdict.  Returns (verdict, rows)."""
    rows = []

    def emit(phase, seconds, **kw):
        rec = {"phase": phase, "seconds": round(seconds, 3), **kw}
        out(json.dumps(rec))
        rows.append(rec)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for, but CUDA is "
                               "not available")
        torch.cuda.init()
        name = torch.cuda.get_device_name(dev)
        n = torch.cuda.device_count()
    else:
        name, n = "cpu", 1
    emit("attach", time.perf_counter() - t0, platform=dev.type, kind=name,
         n=n)

    for mb in (1, 32):
        host = np.zeros((mb * 1024 * 1024 // 4,), np.float32)
        t0 = time.perf_counter()
        on = torch.from_numpy(host).to(dev, copy=True)
        sync()
        h2d = time.perf_counter() - t0
        t0 = time.perf_counter()
        on.cpu().numpy()
        d2h = time.perf_counter() - t0
        emit(f"h2d_{mb}mb", h2d, mbps=round(mb / max(h2d, 1e-9), 1))
        emit(f"d2h_{mb}mb", d2h, mbps=round(mb / max(d2h, 1e-9), 1))

    x = torch.ones(8, 128, device=dev)
    x * 2.0 + 1.0
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        x * 2.0 + 1.0
        sync()
    s = time.perf_counter() - t0
    emit("dispatch_x20", s, ms_per_call=round(s / 20 * 1e3, 2))

    m = torch.ones(512, 512, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    m @ m + torch.sin(m).sum()
    sync()
    emit("first_small_program", time.perf_counter() - t0)

    a = torch.ones(SHAPE, device=dev)
    built = {}
    t0 = time.perf_counter()
    if dev.type == "cuda":
        from .. import kernels

        nvcc_s = kernels.build()[1]          # 0 when the library exists
        built = dict(built=nvcc_s > 0, nvcc_seconds=round(nvcc_s, 3))
    o = scale_shift(a)
    sync()
    emit("kernel_first_run", time.perf_counter() - t0, **built)
    t0 = time.perf_counter()
    o = scale_shift(a)
    sync()
    emit("kernel_steady", time.perf_counter() - t0)
    if not torch.equal(o, a * 2.0 + 1.0):
        raise AssertionError("the probe kernel differs from a * 2 + 1")

    link = verdict(rows)
    out(json.dumps({"phase": "verdict", "link": link}))
    return link, rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    probe(args.device)


if __name__ == "__main__":
    sys.exit(main())
