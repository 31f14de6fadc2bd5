"""The control of the comparison: the reference, put in the program's
place and computed in the nearest precision below the configurations'
float32 with TF32 off, which is TF32.  The precision a later change would
be tempted to lower is the ray-triangle test's (a tensor-core product
takes its operands in TF32), so the control rounds every operand of the
reference's Moller-Trumbore test to TF32 (10 mantissa bits, to nearest,
ties away from zero, as ``cvt.rna.tf32.f32``) and keeps the rest of the
reference in float32.  ``readings.py`` runs it; its reading has to fail
the comparison."""

from __future__ import annotations

import contextlib

import torch


def tf32(x):
    """``x`` rounded to TF32; infinities and NaN pass unchanged."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), r, x)


@contextlib.contextmanager
def tf32_intersections():
    """Within the block every reference cast tests its triangles on TF32
    operands."""
    from .reference.ops import brute, intersect, lbvh

    exact = intersect._mt

    def mt(o, d, v0, e1, e2):
        r = lambda c: tuple(tf32(x) for x in c)
        return exact(r(o), r(d), r(v0), r(e1), r(e2))

    mods = (brute, intersect, lbvh)
    for m in mods:
        m._mt = mt
    try:
        yield
    finally:
        for m in mods:
            m._mt = exact
