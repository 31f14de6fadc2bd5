"""The queued fat-leaf traversal (clive2_tpu_torch/ops/traverse_stream2.py:
queued_cast and its plain steps) on the CPU.

* the round schedule, driven by the plain steps, equals ``stream2_plain``
  bit for bit (ids, t, u, v; any-hit ids too) on closest, masked, capped
  and any-hit casts, for chunks of 1 ray up to the whole cast and tail
  sizes from 0 (rounds until every ray is done) to past the cast (the tail
  takes it whole), and it equals the JAX package's interpret-mode stream2
  kernel and gather walk within the bounds tests/test_torch_stream2.py
  states;
* on built adversarial sets (rays through vertices and shared edges,
  grazing rays, origins far from the centre, slivers, huge and tiny
  triangles), where nearly every ray is a near tie, the schedule equals
  ``stream2_plain`` bit for bit under every schedule, closest-hit and
  any-hit;
* the binning puts every live ray into its fat leaf's tiles once.

The kernels run only on the card (tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clive2_tpu.ops import traverse_stream2 as jax_stream2
from clive2_tpu_torch.ops import intersect
from clive2_tpu_torch.ops import traverse_stream2 as s2
from test_torch_intersect import _rays, _soup, _t
from test_torch_stream2 import MAX_MISMATCH, _jax_tree, _mismatch

torch.set_num_threads(2)

CASES = {
    # name: (triangles, rays, masked, capped, any_hit)
    "closest": (900, 300, False, False, False),
    "masked": (600, 300, True, False, False),
    "capped": (900, 300, False, True, False),
    "any_hit": (900, 300, True, True, True),
}
SCHEDULES = {
    # name: (chunk, tail_min)
    "whole_chunk_no_tail": (s2.CHUNK, 0),
    "one_ray_chunks": (1, 0),
    "chunks_of_7_tail_3": (7, 3),
    "chunks_of_64_tail_20": (64, 20),
    "tail_takes_all": (s2.CHUNK, 1 << 40),
}


def _case(name, seed):
    t, n, masked, capped, any_hit = CASES[name]
    rng = np.random.default_rng(seed)
    verts = _soup(rng, t)
    soup, bvh, rows = _jax_tree(verts)
    o, d = _rays(rng, n)
    active = rng.uniform(size=n) < 0.6 if masked else np.ones(n, bool)
    t_max = (rng.uniform(1.0, 14.0, n).astype(np.float32) if capped
             else np.full(n, np.inf, np.float32))
    tables = {k: _t(v) for k, v in s2.pack_stream2(
        rows["node_packed"], rows["leaf_packed"]).items()}
    return (soup, bvh, rows, tables, (_t(o), _t(d), _t(active), _t(t_max)),
            any_hit)


def _queued(tables, rays, any_hit, chunk, tail_min):
    n = rays[0].shape[0]
    out = (torch.empty(n, dtype=torch.int32), torch.empty(n),
           torch.empty(n), torch.empty(n))
    stats = s2.queued_cast(rays, s2.PlainSteps(tables, any_hit), out,
                           chunk=chunk, tail_min=tail_min)
    return out, stats


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _adversarial(rng, kind, s=96):
    """(triangles v0 e1 e2 [s, 3] each, ray origins and directions [k, 3])
    of one adversarial set."""
    if kind == "shared_edges":      # a fan: every triangle shares two edges
        ang = np.linspace(0, 2 * np.pi, s + 1)
        rim = np.stack([np.cos(ang), np.sin(ang), 0.1 * np.sin(3 * ang)], 1)
        v0 = np.zeros((s, 3))
        e1, e2 = rim[:-1], rim[1:]
        pts = np.concatenate([rim[:-1] * 0.5, rim[:-1], np.zeros((1, 3))])
        scale = 1.0
    else:
        c = rng.uniform(-1, 1, (s, 1, 3))
        tri = c + rng.uniform(-0.3, 0.3, (s, 3, 3))
        if kind == "slivers":
            tri[:, 2] = tri[:, 0] + 1e-4 * (tri[:, 1] - tri[:, 0]) \
                + 1e-5 * rng.normal(size=(s, 3))
        scale = {"huge": 1e3, "tiny": 1e-3}.get(kind, 1.0)
        tri = tri * scale
        v0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        pts = np.concatenate([tri[:, 0], tri[:, 1], tri[:, 2],
                              0.5 * (tri[:, 0] + tri[:, 1])])
    k = len(pts)
    if kind == "grazing":           # in the plane of a triangle, through it
        i = rng.integers(0, s, k)
        n = _unit(np.cross(e1[i], e2[i]))
        along = _unit(np.cross(n, rng.normal(size=(k, 3))))
        target = v0[i] + 0.3 * e1[i] + 0.3 * e2[i]
        d = _unit(along + 1e-6 * rng.normal(size=(k, 1)) * n)
        o = target - 3 * scale * d
    else:
        far = 1e4 if kind == "far_origin" else 3.0 * scale
        o = pts + far * _unit(rng.normal(size=(k, 3)))
        d = _unit(pts - o)
    return (v0, e1, e2), o, d


KINDS = ["shared_edges", "vertices", "grazing", "far_origin", "slivers",
         "huge", "tiny"]


def _adversarial_case(kind):
    """Tables and rays (all active, no cap) of one adversarial set; the fan
    and the vertex set are drawn with more triangles than the rest, which
    at 96 are too few to cut into fat leaves."""
    rng = np.random.default_rng(70 + KINDS.index(kind))
    size = 256 if kind in ("shared_edges", "vertices") else 96
    (v0, e1, e2), o, d = _adversarial(rng, kind, size)
    _, _, rows = _jax_tree(np.stack([v0, v0 + e1, v0 + e2], 1)
                           .astype(np.float32))
    tables = {k: _t(v) for k, v in s2.pack_stream2(
        rows["node_packed"], rows["leaf_packed"]).items()}
    n = o.shape[0]
    rays = (_t(o.astype(np.float32)), _t(d.astype(np.float32)),
            torch.ones(n, dtype=torch.bool), torch.full((n,), torch.inf))
    return tables, rays


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("case", list(CASES) + [f"adversarial_{k}"
                                                 for k in KINDS])
def test_schedule_equals_stream2_plain(case, schedule):
    """The schedule equals ``stream2_plain`` bit for bit: on the random
    ``CASES``, and on each adversarial set both closest-hit and any-hit."""
    chunk, tail_min = SCHEDULES[schedule]
    if case in CASES:
        _, _, _, tables, rays, any_hit = _case(
            case, 40 + list(CASES).index(case))
        modes = (any_hit,)
    else:
        tables, rays = _adversarial_case(case.removeprefix("adversarial_"))
        modes = (False, True)
    if chunk == 1:
        rays = tuple(x[:120] for x in rays)  # 120 one-ray chunks
    o, d, active, t_max = rays
    for any_hit in modes:
        got, (rounds, tail) = _queued(tables, rays, any_hit, chunk, tail_min)
        want = s2.stream2_plain(o, d, tables, active=active, t_max=t_max,
                                any_hit=any_hit)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert (want[0] >= 0).sum() > 2
        if tail_min == 0:
            assert tail == 0 and rounds > 0
        if tail_min > o.shape[0]:
            # one round runs before the first count is read; the tail
            # takes every ray still live after it
            assert rounds == 1 and 0 < tail <= int(active.sum())


@pytest.mark.parametrize("case", ["closest", "capped", "any_hit"])
def test_schedule_matches_jax_kernel_and_gather_walk(case):
    """At the JAX package's stream2 tolerance against its interpret-mode
    kernel; every id (closest) or verdict (any-hit) equal to the gather
    walk's."""
    soup, bvh, rows, tables, rays, any_hit = _case(
        case, 50 + list(CASES).index(case))
    o, d, active, t_max = rays
    got, _ = _queued(tables, rays, any_hit, 97, 11)
    packed = {k: jnp.asarray(v) for k, v in
              jax_stream2.pack_stream2(bvh, soup).items()}
    ref = jax_stream2.intersect_stream2(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), packed,
        interpret=True, any_hit=any_hit, active=jnp.asarray(active.numpy()),
        t_max=jnp.asarray(t_max.numpy()))
    walk = intersect.intersect_bvh_packed(
        o, d, {k: _t(v) for k, v in rows.items()}, active=active,
        t_max=t_max)
    if any_hit:
        blocked = walk[0].numpy() >= 0
        np.testing.assert_array_equal(got[0].numpy() >= 0, blocked)
        assert ((np.asarray(ref[0]) >= 0) != blocked).mean() <= MAX_MISMATCH
        return
    assert _mismatch(got, walk, f"{case} vs gather walk") == 0.0
    _mismatch(got, ref, f"{case} vs jax interpret")


def test_binning_queues_each_live_ray_once():
    _, _, _, tables, rays, any_hit = _case("masked", 60)
    steps = s2.PlainSteps(tables, any_hit)
    st_ = steps.state(rays[0].shape[0])
    steps.walk(st_, rays)
    live, tiles = steps.bin(st_)()
    pos, f = s2.queue_positions(st_)
    want = torch.nonzero(st_.leaf >= 0).squeeze(1)
    assert live == want.numel() == pos.numel() > 0
    assert torch.equal(torch.sort(st_.queue[pos].long()).values, want)
    assert torch.equal(st_.leaf[st_.queue[pos].long()].long(), f)
    assert torch.equal(st_.hist, torch.bincount(
        st_.leaf[want].long(), minlength=st_.hist.numel()).int())
    # each fat leaf starts a tile, so a tile's first entry names its fat
    # leaf (the kernel reads it from there); tiles hold one fat leaf each
    padded = (st_.hist + 127) // 128 * 128
    assert torch.equal(st_.offs, (torch.cumsum(padded, 0) - padded).int())
    assert (st_.offs % s2.TILE == 0).all()
    assert tiles == int(padded.sum()) // s2.TILE <= st_.max_tiles
    assert torch.equal(st_.cursor, st_.offs)
