"""Run one cell of ``BENCHMARK.json`` once, on the machine it is started
on, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m benchmark.run ...`` is the same).  Set-up builds the cell's
scene and renderer from its configuration and traffic and runs the
warm-up samples; the window then calls the traffic's mode back to back for
``--seconds``.  After the window the program's state is freed and the
reference renders the checked sample (``compare.py``).  The last line of
standard output is the result's JSON; the last lines of standard error are
the compared numbers beside their limits.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` profiles
a short stretch in the middle of the window and reports the per-layer
metrics, the device's busy and window seconds, and a breakdown.

Everything the run writes stays in the checkout: the meshes under
``benchmark/_work/resources`` (written once per checkout), the traced
stretch's Chrome trace at ``benchmark/_work/trace.json`` (removed once it
is read), and the program's kernel library in its own build folder.

Exit codes: 0 with a result; 2 for bad arguments; 3 without the cards the
cell asks for; 4 when JAX or the JAX package was loaded.  None of these but
0 prints a result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORK = os.path.join(HERE, "_work")
RESOURCES = os.path.join(WORK, "resources")
TRACE_FILE = os.path.join(WORK, "trace.json")
# top-level module names that may not be loaded in the process that prints
# the result
FORBIDDEN = ("jax", "jaxlib", "flax", "clive2_tpu")


def _process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    compared whole: ``clive2_tpu_torch`` is not ``clive2_tpu``."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                        else modules)}
    return sorted(names & set(FORBIDDEN))


def _environment(resources):
    """The program's environment: no knob of its own but the meshes'
    folder; caches inside the checkout."""
    for k in [k for k in os.environ if k.startswith("CLIVE2_")]:
        del os.environ[k]
    os.environ["CLIVE2_RESOURCES"] = resources
    os.environ["TRITON_CACHE_DIR"] = os.path.join(WORK, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(WORK,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class _HostMark:
    """A host-clock stand-in for a CUDA event, for runs on the CPU (the
    tests')."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, later):
        return 1e3 * (later.t - self.t)


def run_window(session, seconds, trace, spans, trace_samples, cuda=True):
    """Drive the session for ``seconds``, and on until it has taken its
    checked sample.  Returns the window's records and, with ``trace``, the
    traced stretch's sample count."""
    import torch

    from . import tracing

    mark = ((lambda: torch.cuda.Event(enable_timing=True)) if cuda
            else _HostMark)
    start = mark()
    done = []
    traced = 0
    t0 = time.perf_counter()
    start.record()
    while True:
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds and session.checked:
            break
        if trace and not traced and elapsed >= seconds / 2:
            with tracing.profiled(TRACE_FILE, cuda):
                spans.on = True
                for _ in range(trace_samples):
                    with torch.profiler.record_function(tracing.SAMPLE):
                        session.step(elapsed / seconds)
                    done.append(mark())
                    done[-1].record()
                spans.on = False
            traced = trace_samples
            continue
        session.step(elapsed / seconds)
        done.append(mark())
        done[-1].record()
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    marks = [start] + done
    intervals = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    return dict(seconds=window_s, samples=len(done), intervals=intervals,
                peak_bytes=peak), traced


def run(c, args, device="cuda", resources=RESOURCES):
    """One run of the cell ``c`` (``manifest.cell``) on ``device``, once
    the chips are there.  Returns the result's dict, or None when a
    forbidden module was loaded."""
    import torch

    from . import compare, manifest, meshgen, tracing

    cuda = torch.device(device).type == "cuda"
    _environment(resources)
    os.makedirs(WORK, exist_ok=True)
    config, traffic = c["config"], c["traffic"]
    meshgen.ensure_meshes(config, resources)
    mode = manifest.load_mode(traffic["mode"])

    session = mode.Session(config, traffic, args.seed, device)
    spans = None
    if args.trace:
        spans = tracing.CastSpans()
        spans.install()
        tracing.warm_profiler(cuda)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T0

    window, traced = run_window(session, args.seconds, args.trace, spans,
                                int(traffic.get("trace_samples", 3)), cuda)
    records = dict(window=window, setup_s=setup_s,
                   scene_build_s=session.scene_build_s)
    device_info = dict(
        platform="gpu" if cuda else "cpu",
        kind=torch.cuda.get_device_name(0) if cuda else "cpu",
        count=int(c["workload"]["chips"]),
        memory_peak_bytes=window["peak_bytes"])
    breakdown = None
    if args.trace:
        spans.uninstall()
        casts = [dict(k, active=int(k["active"])) for k in spans.casts]
        if traced:
            t = tracing.records(TRACE_FILE, casts, traced,
                                session.scene_build_s, session.n_triangles)
            tracing.remove(TRACE_FILE)
            records["trace"] = t
            device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
            breakdown = dict(device_ops=t["device_ops"],
                             idle_gaps=t["idle_gaps"])
    wanted = c["per_layer"] if args.trace else c["end_to_end"]
    metrics = {}
    for m in wanted:
        value = manifest.load_metric(m["name"]).read(records)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])

    t_check = time.perf_counter()
    values = mode.check(session, resources)
    print(f"benchmark: the check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    limits = compare.limits_for(c["workload"]["name"], HERE)
    if values is None:
        correct, rows = False, [(k, None, v) for k, v in limits.items()]
    else:
        correct, rows = compare.verdict(values, limits)

    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return None
    result = dict(correct=correct, attempted=window["samples"],
                  failed=0 if correct else 1, metrics=metrics,
                  device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    return result


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from . import manifest

    c = manifest.cell(manifest.load_manifest(ROOT), args.workload, ROOT)
    chips = int(c["workload"]["chips"])
    import torch

    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < chips:
        print(f"benchmark: the cell asks for {chips} CUDA card(s); torch "
              f"sees {seen}", file=sys.stderr)
        return 3
    result = run(c, args)
    if result is None:
        return 4
    for k, row in result["check"].items():
        print(f"check {k} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    if not __package__:                 # run as a file: import as a package
        sys.path[0] = ROOT
        from benchmark.run import main as _main
        sys.exit(_main())
    sys.exit(main())
