"""The comparison that decides ``correct``.

The program's renderer state before and after one sample of the window
(``before``, ``after``) is held against the reference: the reference
renders that sample from the seed and the sample index
(``reference.integrator.render.render_sample``) and accumulates it into the
program's ``before`` (``reference...accumulate``), which gives ``expected``.

Numbers compared, each with its limit (``LIMITS``; a cell may give its own
in ``limits/<workload>.json``):

* ``off_share``: the share, in %, of the accumulated values (every pixel's
  image in three channels, its filter weight, its unidirectional image in
  three channels and its squared luma) in which the program's sample
  departs from the reference's by more than ``TOL`` of the reference
  sample's value, beyond the rounding of one f32 addition into the
  accumulator.  A lane whose path meets an exact tie, or a Russian-roulette
  test within rounding, can follow another path on the two sides; what is
  left is held to the limit.
* ``count_gap``: how far the sample counters (``n_samples``, each pixel's
  ``pixel_count``) moved from one sample each in the checked sample, and
  how far the renderer's final ``n_samples`` lies from the samples it was
  asked for.  Exact: limit 0.
"""

from __future__ import annotations

import json
import os

import torch

TOL = 1e-3
# set from the readings recorded in PERF.md: the program's largest over a
# dozen seeds and more, 0.491 (sponza.1080p; cornell.1080p reads 0), and
# the control's smallest, 60.07 (cornell.1080p)
LIMITS = dict(off_share=6.0, count_gap=0.0)
CHANNELS = (("summed_image", 3), ("summed_weight", 1),
            ("summed_unidirectional", 3), ("summed_sq", 1))


def limits_for(workload: str, here: str) -> dict:
    """``LIMITS``, with those of ``limits/<workload>.json`` over them."""
    out = dict(LIMITS)
    path = os.path.join(here, "limits", f"{workload}.json")
    if os.path.exists(path):
        with open(path) as f:
            out.update(json.load(f))
    return out


def off_share(before, after, expected, sample_ref) -> float:
    """The share, in %, of accumulated values off by more than ``TOL``."""
    off = 0
    total = 0
    for name, _ in CHANNELS:
        a = after[name].double()
        e = expected[name].double()
        s = sample_ref[name].double().abs()
        floor = 1e-3 * float(s.mean()) + 1e-30
        slack = 2.0 ** -23 * (a.abs() + e.abs())      # one f32 rounding each
        dev = torch.clamp((a - e).abs() - slack, min=0.0) / (s + floor)
        bad = ~(dev <= TOL)                           # NaN counts as off
        off += int(bad.sum())
        total += bad.numel()
    return 100.0 * off / total


def off_detail(before, after, expected, sample_ref) -> dict:
    """Per accumulator, the share in % of its values off, and the
    deviations (``off_share``'s measure) at a few quantiles of its off
    values: a reading's diagnosis (``readings.py``)."""
    out = {}
    for name, _ in CHANNELS:
        a = after[name].double()
        e = expected[name].double()
        s = sample_ref[name].double().abs()
        floor = 1e-3 * float(s.mean()) + 1e-30
        slack = 2.0 ** -23 * (a.abs() + e.abs())
        dev = (torch.clamp((a - e).abs() - slack, min=0.0) / (s + floor))
        bad = ~(dev <= TOL)
        q = torch.nan_to_num(dev[bad], nan=float("inf"))
        qs = (torch.quantile(q.float().cpu(), torch.tensor(
            [0.1, 0.5, 0.9])).tolist() if q.numel() else [])
        out[name] = dict(off=100.0 * float(bad.double().mean()), q=qs)
    return out


def count_gap(before, after, final_samples: int, asked: int) -> float:
    gap = (after["n_samples"] - before["n_samples"] - 1).abs().max()
    gap = float(gap) + float(
        (after["pixel_count"] - before["pixel_count"] - 1.0).abs().max())
    return gap + abs(final_samples - asked)


def sample_state(sample):
    """The values a sample adds to each accumulator (``accumulate``'s
    increments), keyed as the state."""
    from .reference.integrator.render import sample_luma_sq

    return dict(summed_image=sample["image"], summed_weight=sample["weight"],
                summed_unidirectional=sample["unidirectional"],
                summed_sq=sample_luma_sq(sample))


def numbers(before, after, sample_ref, final_samples, asked):
    """The compared numbers of one checked sample: {name: value}."""
    from .reference.integrator.render import accumulate

    expected = accumulate(before, sample_ref)
    return dict(
        off_share=off_share(before, after, expected,
                            sample_state(sample_ref)),
        count_gap=count_gap(before, after, final_samples, asked))


def verdict(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): each number at or under its
    limit."""
    rows = [(k, values[k], limits[k]) for k in limits if k in values]
    ok = len(rows) == len(limits) and all(v <= lim for _, v, lim in rows)
    return ok, rows
