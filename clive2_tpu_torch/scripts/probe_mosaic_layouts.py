"""Layout probes on the card (the counterpart of the JAX package's
scripts/probe_mosaic_layouts.py).

The script asked which DMA slice shapes and matmul operand orders Mosaic
compiles for stream2's fat-leaf feature rows.  Here each probe runs its
Hopper kernel (``ops/mosaic_probes.py``, csrc/mosaic_probes.cu) at the
script's shapes, in the script's order, on bf16 inputs made from numpy
(seed 0):

  dma64    [4, 640, 64]  -> shared [640, 64]; returns the window [8, 64]
           (the script's [8, 128] does not fit a 64-column slot)
  dma128   [4, 640, 128] -> shared [640, 128]; window [8, 128]
  dmaT     [4, 64, 640]  -> shared [64, 640] (K-major); window [8, 128]
  dotT     [64, 640]ᵀ @ [64, 128] -> f32 [640, 128] (K-major A)
  dot128   [640, 128] @ [128, 128] -> f32 [640, 128]

It prints ``devices: ...``, then ``tag: OK`` or ``tag: FAIL <error head>``
for each probe.  OK means that the kernel built, launched, synchronised
and equalled its plain version: a copy bit for bit, a product within
2^-14 (|A|ᵀ|B|) elementwise.  That is the port's counterpart of "Mosaic
compiled it".  Exits 1 when a probe failed.

    python -m clive2_tpu_torch.scripts.probe_mosaic_layouts [--device cuda|cpu]

On the CPU each wrapper is its plain version, so a probe checks that the
tool runs, not a kernel.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..ops import mosaic_probes as mp

# (tag, wrapper in ops/mosaic_probes.py, input shapes), in the script's order
PROBES = (
    ("dma64", "slab_copy", ((4, 640, 64),)),
    ("dma128", "slab_copy", ((4, 640, 128),)),
    ("dmaT", "slab_copy", ((4, 64, 640),)),
    ("dotT", "matmul_t", ((64, 640), (64, 128))),
    ("dot128", "matmul", ((640, 128), (128, 128))),
)
SEED = 0


def arrays(shapes):
    """f32 standard normals at ``shapes`` from one numpy generator."""
    rng = np.random.default_rng(SEED)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def inputs(shapes, device):
    """``arrays`` cast to bf16 on the host (round to nearest even), on
    ``device``."""
    return [torch.from_numpy(a).to(torch.bfloat16).to(device)
            for a in arrays(shapes)]


def held(kernel, args):
    """Run wrapper ``kernel`` on ``args``, synchronise, and hold its output
    to its plain version; returns (output, largest error)."""
    got = getattr(mp, kernel)(*args)
    if got.is_cuda:
        torch.cuda.synchronize(got.device)
    want = getattr(mp, f"{kernel}_plain")(*args)
    err = float((got - want).abs().max())
    if kernel == "slab_copy":
        if not torch.equal(got, want):
            raise AssertionError(f"the copy differs from its plain version "
                                 f"by up to {err}")
    else:
        bound = mp.REL * mp.abs_product(*args, kernel == "matmul_t")
        if not bool(((got - want).abs() <= bound).all()):
            raise AssertionError(f"the product is off its plain version by "
                                 f"up to {err}, past 2^-14 |A|ᵀ|B|")
    return got, err


def run(device="cuda", out=print):
    """Every probe on ``device``: prints the script's lines and returns a
    record per probe (tag, kernel, args, ok, and the output and largest
    error, or the error's head)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for, but CUDA is "
                               "not available")
        names = [f"cuda:{i} {torch.cuda.get_device_name(i)}"
                 for i in range(torch.cuda.device_count())]
    else:
        names = [str(dev)]
    out(f"devices: {names}")
    records = []
    for tag, kernel, shapes in PROBES:
        args = inputs(shapes, dev)
        rec = dict(tag=tag, kernel=kernel, args=args)
        try:
            rec["out"], rec["max_abs_err"] = held(kernel, args)
            rec["ok"] = True
            out(f"{tag}: OK")
        except Exception as e:       # the script's probe: report, go on
            rec.update(ok=False, error=str(e).replace("\n", " ")[:240])
            out(f"{tag}: FAIL {rec['error']}")
        records.append(rec)
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    records = run(args.device, out=lambda line: print(line, flush=True))
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
