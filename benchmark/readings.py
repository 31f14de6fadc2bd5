"""The readings the comparison's limits are set from (``compare.py``), for
one cell, in one process: the program's numbers over many seeds, and the
control's (``control.py``: the reference computed with TF32 operands in
its ray-triangle test, put in the program's place) over a few.

    python3 benchmark/readings.py --workload sponza.1080p \\
        --seeds 11,12,13 --control-seeds 11,12,13

Per seed: a renderer on the cell's scene (built once), the traffic's
warm-up samples and one or two more, the last of them checked as a run
checks its sample.  Prints one JSON line per reading and a summary line:
the program's largest and the control's smallest of each number.  The
benchmark's runs do not run this; it needs a CUDA card unless ``--device
cpu`` (tests, small traffic).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def readings(c, seeds, control_seeds, device, resources):
    import torch

    import clive2_tpu_torch as ct

    from . import compare, control, meshgen
    from .modes.progressive import reference_sample

    config, traffic = c["config"], c["traffic"]
    meshgen.ensure_meshes(config, resources)
    w, h = int(traffic["width"]), int(traffic["height"])
    scene = ct.create_scene_from_preset(config["preset"], w, h,
                                        device=device)
    ref_scene = None
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        r = ct.Renderer(scene, seed=int(seed) % 2 ** 32, device=device)
        for _ in range(int(traffic["warmup_samples"]) + seed % 2):
            r.run_sample()
        before, index = r.state, r.samples
        r.run_sample()
        after = r.state
        r.block()
        final = r.samples
        del r
        with torch.no_grad():
            t0 = time.perf_counter()
            sample, ref_scene = reference_sample(
                config, traffic, seed, index, resources, device, ref_scene)
            if device != "cpu":
                torch.cuda.synchronize()
            ref_s = time.perf_counter() - t0
            if seed in seeds:
                from .reference.integrator.render import accumulate

                out.append(dict(kind="program", seed=seed, index=index,
                                reference_s=ref_s, **compare.numbers(
                                    before, after, sample, final, final),
                                detail=compare.off_detail(
                                    before, after, accumulate(before, sample),
                                    compare.sample_state(sample))))
            if seed in control_seeds:
                from .reference.integrator.render import accumulate

                with control.tf32_intersections():
                    ctrl, _ = reference_sample(config, traffic, seed, index,
                                               resources, device, ref_scene)
                out.append(dict(kind="control", seed=seed, index=index,
                                **compare.numbers(
                                    before, accumulate(before, ctrl), sample,
                                    final, final)))
        print(json.dumps(out[-1]), flush=True)
        del sample, before, after
    return out


def summary(rows):
    prog = [r for r in rows if r["kind"] == "program"]
    ctrl = [r for r in rows if r["kind"] == "control"]
    keys = ("off_share", "count_gap")
    return dict(
        program_max={k: max(r[k] for r in prog) for k in keys} if prog
        else None,
        control_min={k: min(r[k] for r in ctrl) for k in keys} if ctrl
        else None,
        seeds=len(prog), control_seeds=len(ctrl))


def main(argv=None):
    from . import manifest, run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    parse = lambda s: [int(x) for x in s.split(",") if x]
    c = manifest.cell(manifest.load_manifest(run.ROOT), a.workload, run.ROOT)
    run._environment(run.RESOURCES)
    os.makedirs(run.WORK, exist_ok=True)
    rows = readings(c, parse(a.seeds), parse(a.control_seeds), a.device,
                    run.RESOURCES)
    print(json.dumps(dict(kind="summary", workload=a.workload,
                          **summary(rows))), flush=True)
    return 0


if __name__ == "__main__":
    if not __package__:
        sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
        from benchmark.readings import main as _main
        sys.exit(_main())
    sys.exit(main())
