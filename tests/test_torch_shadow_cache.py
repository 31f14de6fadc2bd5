"""The port's shadow-occluder cache study
(clive2_tpu_torch/scripts/shadow_cache_study.py) against the JAX package's
scripts/shadow_cache_study.py on the CPU.

* ``occludes`` (float64 Möller-Trumbore) equals the script's own function
  (taken from its ``main``, over the same vertices) on random rays and on
  its edges: u + v = 1, t at DELTA, t at t_max, a degenerate triangle (NaN:
  not occluded) and tri = -1.
* The whole study on Cornell ``empty`` 24x24, 3 samples, seed 11 against
  the script (its module globals set, its ``main`` run, its connection
  casts recorded): each transition's active, occluded and cache-hit masks
  slot by slot, equal on every (strategy, pixel) slot that no near tie
  can move, and its counts within the rays of the slots that one can.
  Both renders run under ``NearTies``, whose ties are held to
  tests/torch_parity.py's bound (at most 30 differing rays per sample).
* The slots follow each sample's lane -> pixel map: the transitions with
  their lanes permuted by random maps give the raster order's figures.
* The disagreements (cache hits the float64 test confirms on rays the cast
  called unoccluded) are counted, where the script's assert cannot fire.
* The CLI exits 0 with ``--device cpu``; without a card its default
  raises.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from clive2_tpu import renderer as jax_renderer
from clive2_tpu_torch.scripts import shadow_cache_study as study
from torch_parity import NearTies, check_ties

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 24
SAMPLES = 3
PAIRS = 36                  # connection strategies per slot


def _jax_script():
    """The script as a module; it reads its arguments from ``sys.argv`` at
    import, so it is imported with none (its globals are set after)."""
    spec = importlib.util.spec_from_file_location(
        "jax_shadow_cache_study",
        os.path.join(ROOT, "scripts", "shadow_cache_study.py"))
    module = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["shadow_cache_study.py"])
        spec.loader.exec_module(module)
    return module


def _jax_occludes(script, verts):
    """The script's ``occludes``, a closure of its ``main`` over the soup's
    vertices, bound to ``verts``."""
    code, = [c for c in script.main.__code__.co_consts
             if isinstance(c, types.CodeType) and c.co_name == "occludes"]
    assert code.co_freevars == ("verts",)
    return types.FunctionType(code, script.__dict__, "occludes", None,
                              (types.CellType(verts),))


# ---- occludes -------------------------------------------------------------

def _edge_case():
    """Triangles and rays on the test's edges; every figure exact in
    float64.  Triangle 0: (0,0,0), (1,0,0), (0,1,0); 1: the same at z =
    -DELTA; 2: degenerate (three equal vertices)."""
    verts = np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                      [[0, 0, -1e-4], [1, 0, -1e-4], [0, 1, -1e-4]],
                      [[0.2, 0.2, 0]] * 3], np.float64)
    down = [0, 0, -1]
    rays = [  # (tri, origin, direction, t_max, occluded)
        (0, [0.25, 0.25, 1], down, 2.0, True),
        (0, [0.25, 0.75, 1], down, 2.0, True),     # u + v = 1
        (0, [0.5, 0.5, 1], down, 2.0, True),       # u + v = 1
        (0, [0.5, 0.5000001, 1], down, 2.0, False),  # u + v > 1
        (0, [0, 0, 1], down, 2.0, True),           # a vertex
        (0, [-1e-7, 0.5, 1], down, 2.0, False),    # u < 0
        (0, [0.25, 0.25, 1], down, 1.0, False),    # t = t_max
        (0, [0.25, 0.25, 1], down, 1.0000001, True),
        (1, [0.25, 0.25, 0], down, 2.0, False),    # t = DELTA
        (1, [0.25, 0.25, 1e-7], down, 2.0, True),  # t just past DELTA
        (0, [0.25, 0.25, 1], [0, 0, 1], 2.0, False),  # behind the origin
        (2, [0.2, 0.2, 1], down, 2.0, False),      # degenerate: NaN
        (-1, [0.25, 0.25, 1], down, 2.0, False),   # no candidate
        (0, [0.25, 0.25, 1], [1, 0, 0], 2.0, False),  # parallel: a = 0
    ]
    tri = np.array([r[0] for r in rays], np.int32)
    o = np.array([r[1] for r in rays], np.float32)
    d = np.array([r[2] for r in rays], np.float32)
    t_max = np.array([r[3] for r in rays], np.float32)
    return verts, tri, o, d, t_max, np.array([r[4] for r in rays])


def _random_case(n=20000, seed=2):
    g = np.random.default_rng(seed)
    verts = g.uniform(-1, 1, (64, 3, 3))
    tri = g.integers(-1, 64, n).astype(np.int32)
    target = verts[np.maximum(tri, 0)].mean(1) + g.normal(0, 0.3, (n, 3))
    o = g.uniform(-3, 3, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = g.uniform(0, 6, n)
    return (verts, tri, o.astype(np.float32), d.astype(np.float32),
            t_max.astype(np.float32))


@pytest.mark.parametrize("case", ["edges", "random"])
def test_occludes_matches_the_script(case):
    script = _jax_script()
    if case == "edges":
        verts, tri, o, d, t_max, want_edges = _edge_case()
    else:
        verts, tri, o, d, t_max = _random_case()
    with np.errstate(invalid="ignore"):
        want = _jax_occludes(script, verts)(tri, o, d, t_max)
    got = study.occludes(torch.from_numpy(verts), torch.from_numpy(tri),
                         torch.from_numpy(o), torch.from_numpy(d),
                         torch.from_numpy(t_max), chunk=4096).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "edges":
        np.testing.assert_array_equal(got, want_edges)
    else:
        assert 0.05 < got.mean() < 0.95


def test_disagreements_are_counted():
    """A slot whose candidate still blocks today's ray while the cast
    called it unoccluded is a cache hit and a disagreement; the script's
    ``assert ... or True`` would pass it silently."""
    verts, *_ = _edge_case()
    o = torch.tensor([[[0.25, 0.25, 1], [0.25, 0.25, 1], [0.9, 0.9, 1]]])
    d = torch.tensor([[0.0, 0, -1]] * 3)[None]
    cur = dict(o=o, d=d, active=torch.tensor([[True, True, True]]),
               t_max=torch.tensor([[2.0, 2.0, 2.0]]),
               tri=torch.tensor([[0, -1, -1]], dtype=torch.int32))
    prev = torch.tensor([[0, 0, 0]], dtype=torch.int32)
    c = study.transition(prev, cur, torch.arange(3),
                         torch.from_numpy(verts))
    assert c == dict(active=3, occluded=1, cache_hit=2, disagreements=1)
    assert c["cache_hit"] <= c["occluded"] + c["disagreements"]


# ---- the whole study against the script -----------------------------------

LINE = re.compile(r"sample (\d+)->(\d+): active (\d+)\s+occluded\s+(\S+)%"
                  r"\s+cache-hit\s+(\S+)%\s+\(=\s+(\S+)% of the occluded")


@contextlib.contextmanager
def _jax_recorded(records, captured):
    """Record, under the script's own patches, every connection cast the
    JAX renderer makes (its rays, active lanes, caps and triangle ids, as
    the script's ``_record`` takes them) and the soup's vertices."""
    from clive2_tpu import scene as jax_scene
    from clive2_tpu.integrator import connect as jax_connect

    cast, build = jax_connect.intersect_scene, jax_scene._build_scene_pytree

    def record(o, d, active, t_max, tri):
        records.append(dict(o=np.asarray(o), d=np.asarray(d),
                            active=np.asarray(active),
                            t_max=np.asarray(t_max), tri=np.asarray(tri)))

    def recording_cast(o, d, scene, active=None, sort=False, t_max=None,
                       any_hit=False):
        out = cast(o, d, scene, active=active, sort=sort, t_max=t_max,
                   any_hit=any_hit)
        jax.debug.callback(record, o, d, active, t_max, out[0],
                           ordered=True)
        return out

    def capturing_build(soup, *a):
        captured["verts"] = np.asarray(soup.vertices, np.float64)
        return build(soup, *a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_connect, "intersect_scene", recording_cast)
        mp.setattr(jax_scene, "_build_scene_pytree", capturing_build)
        yield
        jax.effects_barrier()


@pytest.fixture(scope="module")
def both():
    """The script's run and the port's under NearTies: what the script
    prints, its connection casts and vertices, and the arguments of each
    of the port's ``transition`` calls (raster order: lane = pixel)."""
    script = _jax_script()
    script.PRESET, script.W, script.H, script.K = "empty", W, H, SAMPLES
    jax_renderer._make_step.cache_clear()
    jax.clear_caches()
    out, records, captured, calls = io.StringIO(), [], {}, []
    real_transition = study.transition

    def keep(*args):
        calls.append(args)
        return real_transition(*args)

    with NearTies() as ties:
        with _jax_recorded(records, captured), \
                contextlib.redirect_stdout(out), \
                np.errstate(invalid="ignore", divide="ignore"):
            script.main()
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.MonkeyPatch.context() as mp:
            mp.setattr(study, "transition", keep)
            got = study.run("empty", W, H, SAMPLES, device="cpu")
    jax_renderer._make_step.cache_clear()
    jax.clear_caches()
    want = [tuple(m.groups()) for m in LINE.finditer(out.getvalue())]
    return dict(ties=ties, got=got, want=want, printed=out.getvalue(),
                records=records, verts=captured["verts"], calls=calls,
                occludes=_jax_occludes(script, captured["verts"]))


def _jax_masks(both, k):
    """[P, W*H] (active, occluded, cache hit) of the script's transition
    k-1 -> k, from its recorded casts and its own ``occludes``."""
    prev, cur = both["records"][k - 1], both["records"][k]
    act = cur["active"] & (cur["t_max"] > 0)
    cand = prev["tri"]
    with np.errstate(invalid="ignore", divide="ignore"):
        hit = act & (cand >= 0) & both["occludes"](cand, cur["o"], cur["d"],
                                                  cur["t_max"])
    return [m.reshape(PAIRS, W * H) for m in (act, act & (cur["tri"] >= 0),
                                              hit)]


def _port_masks(call):
    """[P, W*H] (active, occluded, cache hit) by pixel of one of the
    port's transitions."""
    prev, cur, pixel, verts = call
    out = []
    for m in study.slot_hits(prev, cur, pixel, verts):
        by_pixel = np.zeros(m.shape, bool)
        by_pixel[:, pixel.numpy()] = m.numpy()
        out.append(by_pixel)
    return out


def _conn(casts, k):
    """Sample k's recorded connection cast (the 7th cast of each sample)."""
    return np.asarray(casts[7 * k + 6])


def test_study_matches_the_script(both):
    """Each transition slot by slot against the script's.  The script's
    figures are recomputed from its recorded connection casts with its own
    ``occludes`` and must print as it printed them.  Its renderer and the
    port's differ only where near ties move a cast (tests/torch_parity.py):
    a (strategy, pixel) slot whose pixel has a differing ray in sample k
    may change its active and occluded state, and one with a differing ray
    in sample k or k-1 (the candidate's sample) its cache hit.  Every other
    slot must agree exactly on all three.  The counts may differ by at
    most the near slots' rays: active by their active rays on either side,
    occluded by the differing connection rays, cache hits by their rays
    with a candidate on either side.  Measured: 7 and 7 near pixels in
    samples 1 and 2 (12 and 14 with the sample before); active counts 6
    and 0 apart (bounds 201 and 195), occluded 2 and 3 (bounds 6 and 7),
    cache hits 5 and 5 on both sides and their masks equal on every slot
    (bounds 12 and 10)."""
    got, want, ties = both["got"], both["want"], both["ties"]
    assert f"casts/sample = {got['casts_per_sample']}" in both["printed"]
    assert got["casts_per_sample"] == PAIRS * W * H
    assert got["casts_recorded"] == [1] * SAMPLES
    assert len(both["records"]) == SAMPLES
    assert len(want) == len(got["transitions"]) == len(both["calls"]) \
        == SAMPLES - 1
    check_ties(ties, W, H)
    near = [ties.slots(k) for k in range(SAMPLES)]
    conn_rays = [int((_conn(ties.jax_casts, k)
                      != _conn(ties.torch_casts, k)).sum())
                 for k in range(SAMPLES)]
    for k, (row, w, call) in enumerate(
            zip(got["transitions"], want, both["calls"]), start=1):
        assert row["sample"] == f"{w[0]}->{w[1]}" == f"{k - 1}->{k}"
        assert np.array_equal(call[2].numpy(), np.arange(W * H))  # raster
        np.testing.assert_array_equal(call[3].numpy(), both["verts"])
        j_act, j_occ, j_hit = _jax_masks(both, k)
        n_act, n_occ, n_hit = j_act.sum(), j_occ.sum(), j_hit.sum()
        assert (w[2], w[3], w[4], w[5]) == (
            f"{n_act}", f"{n_occ / n_act * 100:5.1f}".strip(),
            f"{n_hit / n_act * 100:5.1f}".strip(),
            f"{n_hit / max(n_occ, 1) * 100:4.1f}".strip())
        p_act, p_occ, p_hit = _port_masks(call)
        moved = np.broadcast_to(near[k], j_act.shape)
        moved_hit = np.broadcast_to(near[k] | near[k - 1], j_act.shape)
        for name, p, j, m in (("active", p_act, j_act, moved),
                              ("occluded", p_occ, j_occ, moved),
                              ("cache hit", p_hit, j_hit, moved_hit)):
            np.testing.assert_array_equal(p[~m], j[~m], err_msg=name)
        assert row["active"] == p_act.sum() and row["occluded"] == \
            p_occ.sum() and row["cache_hit"] == p_hit.sum()
        cand = (call[0].numpy() >= 0) | \
            (both["records"][k - 1]["tri"].reshape(PAIRS, W * H) >= 0)
        assert abs(row["active"] - n_act) <= (moved & (p_act | j_act)).sum()
        assert abs(row["occluded"] - n_occ) <= conn_rays[k], (row, n_occ)
        assert abs(row["cache_hit"] - n_hit) <= \
            (moved_hit & cand & (p_act | j_act)).sum(), (row, n_hit)
        assert 0 < row["cache_hit"] < row["occluded"]


def test_slots_follow_the_lane_to_pixel_map(both):
    """The card's BVH scenes render in Morton order, where lane and pixel
    differ: each of the study's transitions, its lanes permuted by one
    random pixel map in the sample before and another in the sample after
    (``by_slot`` of the first, ``transition`` through the second), gives
    the raster order's counts, and its masks mapped back by pixel are the
    raster order's.  A map applied backwards, or the previous sample's map
    applied to today's lanes, fails."""
    g = np.random.default_rng(5)
    n = W * H
    for prev, cur, pixel, verts in both["calls"]:
        a, b = (torch.from_numpy(g.permutation(n)) for _ in range(2))
        prev_lanes = prev[:, a]           # lane j of sample k-1: pixel a[j]
        prev_b = study.by_slot(prev_lanes, a, n)
        assert torch.equal(prev_b, prev)
        cur_b = {key: v[:, b] if torch.is_tensor(v) else v
                 for key, v in cur.items()}
        want = study.transition(prev, cur, pixel, verts)
        assert study.transition(prev_b, cur_b, b, verts) == want
        assert 0 < want["cache_hit"]
        for got, raster in zip(_port_masks((prev_b, cur_b, b, verts)),
                               _port_masks((prev, cur, pixel, verts))):
            np.testing.assert_array_equal(got, raster)
        # the maps applied backwards (inverse permutations) disagree
        inv = torch.argsort(b)
        assert study.transition(prev_b, cur_b, inv, verts) != want


def test_study_reports_its_disagreements(both):
    for row in both["got"]["transitions"]:
        assert row["disagreements"] >= 0
        assert row["cache_hit"] <= row["occluded"] + row["disagreements"]
        assert row["cast_ms"] > 0


# ---- the CLI --------------------------------------------------------------

def test_cli_on_the_cpu_prints_its_figures():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.run(
        [sys.executable, "-m", "clive2_tpu_torch.scripts.shadow_cache_study",
         "empty", "16", "12", "2", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert lines[0] == (f"empty 16x12, 2 samples; casts/sample = "
                        f"{PAIRS * 16 * 12}")
    assert LINE.match(lines[1]) and lines[2].startswith("  disagreements ")
    figures = json.loads(lines[-1])
    assert figures["casts_recorded"] == [1, 1]
    assert figures["order"] == "raster" and len(figures["transitions"]) == 1


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        study.main(["empty", "8", "8", "2"])
