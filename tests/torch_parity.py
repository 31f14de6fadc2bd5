"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

The JAX package and the port take the same random numbers (threefry, bit for
bit) but not the same float rounding: XLA contracts multiplies and adds
into FMAs and has its own transcendentals.  Those ulp differences are
invisible in most of the image, but a path tracer amplifies them wherever a
discrete outcome sits on a knife edge (a grazing self-hit just past the
1e-4 epsilon, a ray through a triangle edge): the two renderers then trace
a different path for that pixel sample.

``NearTies`` finds those samples exactly instead of guessing: it records the
triangle id every cast reports, in both renderers, and marks a sample slot
as a near tie where any cast of that slot disagrees.  A near-tie slot
touches its pixel's 3x3 filter footprint and the pixels its light subpath
splats onto; every other pixel must match at the golden tests' tolerance.
The unidirectional image takes no connection, and matches on every pixel.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np

import clive2_tpu.integrator.connect as jax_connect
import clive2_tpu.integrator.trace as jax_trace
import clive2_tpu_torch.integrator.connect as torch_connect
import clive2_tpu_torch.integrator.trace as torch_trace

RTOL, ATOL = 2e-4, 1e-5      # tests/test_golden.py's tolerance
# Bounds on how far the near ties may reach, about 3x what was measured on
# the CPU: per 24x24 sample at most 10 of its 27,648 cast rays disagree
# (Cornell 9, 9, 10, 3; glass 8, 8, 4, 6; the 16x16 BVH scene 0, 0), and
# the slots they come from reach 39% of the pixels (Cornell and glass).
# A port fault that flips ids on many rays breaks the first bound before
# the mask can hide it.
MAX_DIFFERING_RAYS = 30
NEAR_TIE_MAX = 0.45


def check_ties(ties, width, height, samples=None):
    """The near-tie mask of ``samples``, after holding the ties to the
    bounds above."""
    counts = ties.differing_rays(samples)
    assert max(counts) <= MAX_DIFFERING_RAYS, counts
    near = ties.pixels(width, height, samples)
    assert near.mean() <= NEAR_TIE_MAX, near.mean()
    return near


class NearTies:
    """Context manager recording both renderers' cast results."""

    def __init__(self):
        self.jax_casts, self.torch_casts = [], []
        self.jax_splats, self.torch_splats = [], []

    def _jax_wrap(self, fn, out):
        def wrapped(*a, **k):
            res = fn(*a, **k)
            jax.debug.callback(lambda x: out.append(np.asarray(x)), res[0],
                               ordered=True)
            return res
        return wrapped

    def _torch_wrap(self, fn, out):
        def wrapped(*a, **k):
            res = fn(*a, **k)
            out.append(res[0].cpu().numpy())
            return res
        return wrapped

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        patches = [
            (jax_trace, "intersect_scene", self._jax_wrap, self.jax_casts),
            (jax_connect, "intersect_scene", self._jax_wrap, self.jax_casts),
            (jax_connect, "_strategy_t1", self._jax_wrap, self.jax_splats),
            (torch_trace, "intersect_scene", self._torch_wrap,
             self.torch_casts),
            (torch_connect, "intersect_scene", self._torch_wrap,
             self.torch_casts),
            (torch_connect, "_strategy_t1", self._torch_wrap,
             self.torch_splats),
        ]
        for mod, name, wrap, out in patches:
            orig = getattr(mod, name)
            setattr(mod, name, wrap(orig, out))
            self._stack.callback(setattr, mod, name, orig)
        return self

    def __exit__(self, *exc):
        jax.effects_barrier()
        self._stack.close()
        return False

    def _sample_starts(self, samples, casts_per_sample):
        assert len(self.jax_casts) == len(self.torch_casts) > 0
        if samples is None:
            samples = range(len(self.jax_casts) // casts_per_sample)
        return [i * casts_per_sample for i in samples]

    def differing_rays(self, samples=None, max_bounces: int = 6):
        """Per recorded sample (all, or the indices in ``samples``): how
        many rays of all its casts report a different triangle id."""
        per = max_bounces + 1
        return [sum(int((a != b).sum()) for a, b in
                    zip(self.jax_casts[s0:s0 + per],
                        self.torch_casts[s0:s0 + per]))
                for s0 in self._sample_starts(samples, per)]

    def pixels(self, width: int, height: int, samples=None,
               max_bounces: int = 6):
        """[H, W] bool: pixels a near-tie slot of the recorded samples
        (all, or the indices in ``samples``) can reach."""
        n = width * height
        casts_per_sample = max_bounces + 1
        near = np.zeros((height, width), bool)
        for s0 in self._sample_starts(samples, casts_per_sample):
            slot = np.zeros(n, bool)
            for a, b in zip(self.jax_casts[s0:s0 + casts_per_sample],
                            self.torch_casts[s0:s0 + casts_per_sample]):
                diff = a != b
                if diff.size == 2 * n:        # merged camera+light trace
                    slot |= diff[:n] | diff[n:]
                else:                         # [P, N] connection cast
                    slot |= diff.reshape(-1, n).any(0)
            img = np.pad(slot.reshape(height, width), 1)
            for dy in range(3):
                for dx in range(3):
                    near |= img[dy:dy + height, dx:dx + width]
            k = s0 // casts_per_sample * max_bounces
            for splats in (self.jax_splats, self.torch_splats):
                for pix in splats[k:k + max_bounces]:
                    pix = pix[slot]
                    near.ravel()[pix[pix < n]] = True
        return near


def assert_match(got, want, near, label):
    """allclose at the golden tolerance on every pixel outside ``near``."""
    got, want = np.asarray(got), np.asarray(want)
    mask = ~near.reshape(near.shape + (1,) * (want.ndim - 2))
    mask = np.broadcast_to(mask, want.shape)
    np.testing.assert_allclose(got[mask], want[mask], rtol=RTOL, atol=ATOL,
                               err_msg=label)
