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
A slot's pixel is its lane for a full frame; for an image stripe, a pixel
subset or a wavefront in Morton order it is the pixel the port's
``trace_and_connect`` gave that lane (``row0 * W + lane``,
``pixel_sel[lane]``, ``pixel_idx[lane]``), recorded per call.  Under the
Morton order the light half of a trace is in ``light_gen_key`` order, and
its lane j belongs to the slot of the light ray generated at ``lorder[j]``,
also recorded per call.
"""

from __future__ import annotations

import contextlib

import jax
import numpy as np

import clive2_tpu.integrator.connect as jax_connect
import clive2_tpu.integrator.trace as jax_trace
import clive2_tpu_torch.integrator.connect as torch_connect
import clive2_tpu_torch.integrator.render as torch_render
import clive2_tpu_torch.integrator.trace as torch_trace
from clive2_tpu_torch.testing import differing_slots, reached_pixels

RTOL, ATOL = 2e-4, 1e-5      # tests/test_golden.py's tolerance
# Bounds on how far the near ties may reach, about 3x what was measured on
# the CPU: per 24x24 sample at most 10 of its 27,648 cast rays disagree
# (Cornell 9, 9, 10, 3; glass 8, 8, 4, 6; the 16x16 BVH scene 0, 0), and
# the slots they come from reach 39% of the pixels (Cornell and glass).
# A port fault that flips ids on many rays breaks the first bound before
# the mask can hide it.
MAX_DIFFERING_RAYS = 30
NEAR_TIE_MAX = 0.45
# The same bounds for the reference estimator (CLIVE2_REFERENCE_MIS=1),
# whose closest-hit connection casts are capped beyond the target and whose
# visibility asks the hit to BE the target: measured on the CPU at 24x24 /
# 4 spp, seed 1234, 9, 9, 10 and 3 differing rays per sample (as for the
# default estimator), reaching 39% of the pixels (15%, 15%, 15% and 6% per
# sample), and 0 on Cornell 16x16, seed 31.  The rays' bound is 3x the
# measured 10; the share cannot grow 3x, so it stays at 0.45.
REFMIS_BOUNDS = dict(max_rays=30, max_share=0.45)


def check_ties(ties, width, height, samples=None,
               max_rays=MAX_DIFFERING_RAYS, max_share=NEAR_TIE_MAX):
    """The near-tie mask of ``samples``, after holding the ties to the
    bounds above (or to those given)."""
    counts = ties.differing_rays(samples)
    assert max(counts) <= max_rays, counts
    near = ties.pixels(width, height, samples)
    assert near.mean() <= max_share, near.mean()
    return near


class NearTies:
    """Context manager recording both renderers' cast results."""

    def __init__(self):
        self.jax_casts, self.torch_casts = [], []
        self.jax_splats, self.torch_splats = [], []
        # per trace_and_connect call: lane -> pixel, and the light order
        # (None in raster order)
        self.torch_pixels, self.torch_light_orders = [], []
        self._lorder = None

    def _jax_wrap(self, fn, out):
        def wrapped(*a, **k):
            res = fn(*a, **k)
            jax.debug.callback(lambda x: out.append(np.asarray(x)), res[0],
                               ordered=True)
            return res
        return wrapped

    def _torch_wrap(self, fn, out, item=0):
        def wrapped(*a, **k):
            res = fn(*a, **k)
            out.append(res[item].cpu().numpy())
            return res
        return wrapped

    def _pairing(self, fn):
        def wrapped(lorder, *a, **k):
            self._lorder = lorder.cpu().numpy()
            return fn(lorder, *a, **k)
        return wrapped

    def _pixels(self, fn):
        def wrapped(sensor_pos, pixel_idx, *a, **k):
            self.torch_pixels.append(pixel_idx.cpu().numpy())
            self.torch_light_orders.append(self._lorder)
            self._lorder = None
            return fn(sensor_pos, pixel_idx, *a, **k)
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
            (torch_render, "pair_lights", lambda fn, _: self._pairing(fn),
             None),
            (torch_render, "filter_weights", lambda fn, _: self._pixels(fn),
             None),
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

    def _lanes(self, sample, n):
        """(lane -> flat pixel, light order or None) of recorded sample
        ``sample``: as recorded from the port's calls, or the identity over
        ``n`` pixels when the samples were traced without
        ``trace_and_connect``."""
        if not self.torch_pixels:
            return np.arange(n), None
        return (self.torch_pixels[sample].astype(np.int64),
                self.torch_light_orders[sample])

    def slots(self, sample, n=None, max_bounces: int = 6):
        """[M] bool: the camera lanes of recorded sample ``sample`` any of
        whose casts (its camera ray's, its paired light ray's, its
        connections') differ between the renderers."""
        per = max_bounces + 1
        s0 = self._sample_starts([sample], per)[0]
        _, lorder = self._lanes(sample, n)
        return differing_slots(self.jax_casts[s0:s0 + per],
                               self.torch_casts[s0:s0 + per], lorder)

    def pixels(self, width: int, height: int, samples=None,
               max_bounces: int = 6):
        """[H, W] bool: pixels a near-tie slot of the recorded samples
        (all, or the indices in ``samples``) can reach."""
        n = width * height
        near = np.zeros((height, width), bool)
        for s0 in self._sample_starts(samples, max_bounces + 1):
            sample = s0 // (max_bounces + 1)
            lanes, _ = self._lanes(sample, n)
            k = sample * max_bounces
            splats = (self.jax_splats[k:k + max_bounces]
                      + self.torch_splats[k:k + max_bounces])
            near |= reached_pixels(self.slots(sample, n, max_bounces),
                                   lanes, splats, width, height)
        return near


def assert_match(got, want, near, label):
    """allclose at the golden tolerance on every pixel outside ``near``."""
    got, want = np.asarray(got), np.asarray(want)
    mask = ~near.reshape(near.shape + (1,) * (want.ndim - 2))
    mask = np.broadcast_to(mask, want.shape)
    np.testing.assert_allclose(got[mask], want[mask], rtol=RTOL, atol=ATOL,
                               err_msg=label)
