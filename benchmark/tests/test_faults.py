"""The check against a broken timed path: the rest of a run is driven on
the CPU (the harness's look for a card skipped) with the program broken
underneath, once per fault this cell can have, and ``correct`` comes out
false.  The faults: a sample that leaves the renderer's state unchanged;
half of the frame's rows left out and the other half counted twice (the
mean taken over the rest); answers altered where they are produced (the
connection's contribution of every 16th lane doubled).  A one-chip cell
has no exchange between chips to leave out."""

import pytest
import torch

import clive2_tpu_torch.renderer as renderer_mod
from clive2_tpu_torch.integrator import render as render_mod

from .helpers import run_small, small_cell


def _state_unchanged(monkeypatch):
    def run_sample(self):
        self.samples += 1
    monkeypatch.setattr(renderer_mod.Renderer, "run_sample", run_sample)


def _half_batch(monkeypatch):
    orig = renderer_mod.render_sample

    def render_sample(*a, **kw):
        s = orig(*a, **kw)
        h = s["image"].shape[0] // 2
        out = dict(s)
        for k in ("image", "weight", "unidirectional"):
            v = s[k].clone()
            v[:h] *= 2.0
            v[h:] = 0.0
            out[k] = v
        return out
    monkeypatch.setattr(renderer_mod, "render_sample", render_sample)


def _answers_altered(monkeypatch):
    orig = render_mod.connect_paths

    def connect_paths(*a, **kw):
        out = dict(orig(*a, **kw))
        c = out["contribution"].clone()
        c[::16] *= 2.0
        out["contribution"] = c
        return out
    monkeypatch.setattr(render_mod, "connect_paths", connect_paths)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answers_altered])
def test_fault_fails_the_check(fault, monkeypatch, tmp_path):
    fault(monkeypatch)
    r = run_small(small_cell(width=48, height=27), tmp_path, seconds=0.6)
    assert r["correct"] is False
    assert r["failed"] == 1
    assert any(row["value"] > row["limit"] for row in r["check"].values())


def test_sound_run_passes(tmp_path):
    r = run_small(small_cell(width=48, height=27), tmp_path, seconds=0.6)
    assert r["correct"] is True
