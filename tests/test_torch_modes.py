"""The port's sampling modes against the JAX package on the CPU: row stripes
(``render_sample(row0=, rows=)``, ``Renderer(chunk_rows=)``), pixel subsets
(``render_sample_subset``), adaptive sampling and ``unweighted_image``.

Renders run on Cornell 24x24, where both packages keep the raster wave
order, and are compared at the golden tolerance (rtol 2e-4, atol 1e-5)
outside near-tie pixels, found by recording both renderers' casts; a
stripe's or subset's slots map to the pixels the port generated camera rays
for (tests/torch_parity.py).  Unidirectional images and per-pixel counts
are compared on every pixel.  The filter's stripe and scatter forms are
held to JAX's at rtol 1e-5 / atol 1e-6 (tests/test_torch_ops.py's).  The
adaptive selection is JAX's ``lax.top_k`` order, ties to the lower pixel,
which ``torch.topk`` does not promise: tested on a state of tied scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu import renderer as jax_renderer
from clive2_tpu.integrator import render as jax_render
from clive2_tpu.ops import filters as jf
from clive2_tpu_torch import renderer as port_renderer
from clive2_tpu_torch import rng
from clive2_tpu_torch.integrator import render as port_render
from clive2_tpu_torch.ops import filters as tf
from torch_parity import NearTies, assert_match, check_ties

torch.set_num_threads(2)

SIZE, CHUNK, SEED = 24, 8, 17
STRIPES = range(0, SIZE, CHUNK)
FIELDS = ("summed_image", "summed_weight", "summed_unidirectional",
          "summed_sq", "pixel_count")
# fields that take no connection: compared on every pixel
UNMASKED = ("summed_unidirectional", "pixel_count", "unidirectional",
            "uni_count")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(got, want, near, names):
    none = np.zeros_like(near)
    for g, w in names:
        assert_match(_np(got[g]), _np(want[w]),
                     none if g in UNMASKED else near, g)


def _to_torch(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


# ---- the filter ------------------------------------------------------------

def _filter_inputs(n, seed):
    g = np.random.default_rng(seed)
    return (g.uniform(size=(n, 3)).astype(np.float32),
            g.uniform(size=(n, 3, 3)).astype(np.float32),
            g.uniform(size=n).astype(np.float32))


@pytest.mark.parametrize("row0,rows", [(0, 3), (3, 3), (9, 3), (0, 12)])
def test_finalize_stripe_matches_jax(row0, rows):
    """A stripe's filter spills one row across each edge it has inside the
    image, where JAX puts it; stripes of a partition sum to the frame."""
    w, h = 13, 12
    c, wt, cws = _filter_inputs(w * rows, row0 + rows)
    want = jf.finalize_samples(jnp.asarray(c), jnp.asarray(wt),
                               jnp.asarray(cws), w, h, row0=row0, rows=rows)
    got = tf.finalize_samples(torch.from_numpy(c), torch.from_numpy(wt),
                              torch.from_numpy(cws), w, h, row0=row0,
                              rows=rows)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    lit = np.flatnonzero(got[1].numpy().any(1))
    assert lit.min() == max(row0 - 1, 0) and lit.max() == min(row0 + rows,
                                                               h - 1)
    # the frame in stripes of 3 rows equals the frame at once
    c, wt, cws = _filter_inputs(w * h, 99)
    full = tf.finalize_samples(*map(torch.from_numpy, (c, wt, cws)), w, h)
    parts = [tf.finalize_samples(
        *(torch.from_numpy(x[r * w:(r + 3) * w]) for x in (c, wt, cws)),
        w, h, row0=r, rows=3) for r in range(0, h, 3)]
    for k in range(2):
        np.testing.assert_allclose(sum(p[k] for p in parts).numpy(),
                                   full[k].numpy(), rtol=1e-5, atol=1e-6)


def test_finalize_scatter_matches_jax():
    """Any pixel subset, repeats and image edges included; over every pixel
    in raster order it equals the shifted-add filter."""
    w, h, m = 13, 7, 200
    g = np.random.default_rng(5)
    pix = np.concatenate([[0, w - 1, w * h - 1, w * (h - 1), 40, 40],
                          g.integers(0, w * h, m - 6)]).astype(np.int32)
    c, wt, cws = _filter_inputs(m, 6)
    want = jf.finalize_samples_scatter(*map(jnp.asarray, (c, wt, cws, pix)),
                                       w, h)
    got = tf.finalize_samples_scatter(*map(torch.from_numpy,
                                           (c, wt, cws, pix)), w, h)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    c, wt, cws = _filter_inputs(w * h, 7)
    args = tuple(map(torch.from_numpy, (c, wt, cws)))
    raster = torch.arange(w * h, dtype=torch.int32)
    for a, b in zip(tf.finalize_samples_scatter(*args, raster, w, h),
                    tf.finalize_samples(*args, w, h)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


# ---- stripes ---------------------------------------------------------------

@pytest.fixture(scope="module")
def striped():
    """Sample 0 stripe by stripe (JAX's chunked step from a zero state, the
    port's render_sample with the key the renderer folds), then 2 samples
    of a chunk_rows=8 renderer in each package; every call's casts
    recorded: stripes 0-2, then the renderers' 6 stripes."""
    js = c2.create_scene_from_preset("empty", SIZE, SIZE)
    ts = ct.create_scene_from_preset("empty", SIZE, SIZE, device="cpu")
    jax_renderer._make_step_chunked.cache_clear()   # trace anew, recording
    jax.clear_caches()
    jr = c2.Renderer(js, seed=SEED, chunk_rows=CHUNK)
    tr = ct.Renderer(ts, seed=SEED, chunk_rows=CHUNK)
    assert jr.chunk_rows == tr.chunk_rows == CHUNK
    stripes = []
    with NearTies() as ties:
        for row0 in STRIPES:
            want = jr._step(jr.key, jnp.uint32(0), jnp.int32(row0),
                            jax_render.init_accumulators(SIZE, SIZE),
                            js.data)
            got = port_render.render_sample(
                rng.fold_in(rng.fold_in(tr.key, 0), row0), ts.data, SIZE,
                SIZE, row0=row0, rows=CHUNK)
            stripes.append((got, {k: np.asarray(v) for k, v in want.items()}))
        for _ in range(2):
            jr.run_sample()
            tr.run_sample()
    return dict(ties=ties, stripes=stripes, jr=jr, tr=tr)


def test_stripes_match_jax(striped):
    for i, (got, want) in enumerate(striped["stripes"]):
        near = check_ties(striped["ties"], SIZE, SIZE, samples=[i])
        _compare(got, want, near, (("image", "summed_image"),
                                   ("weight", "summed_weight"),
                                   ("unidirectional",
                                    "summed_unidirectional")))
        rows = np.zeros(SIZE, bool)
        rows[i * CHUNK:(i + 1) * CHUNK] = True
        np.testing.assert_array_equal(want["pixel_count"][:, 0], rows)
        assert int(want["n_samples"]) == (i == len(STRIPES) - 1)


def test_unidirectional_stripes_tile_the_frame(striped):
    unis = [got["unidirectional"].numpy() for got, _ in striped["stripes"]]
    frame = np.concatenate([u[i * CHUNK:(i + 1) * CHUNK]
                            for i, u in enumerate(unis)])
    for i, u in enumerate(unis):
        outside = np.ones(SIZE, bool)
        outside[i * CHUNK:(i + 1) * CHUNK] = False
        assert not u[outside].any()
    np.testing.assert_array_equal(sum(unis), frame)
    assert (frame.sum(-1) > 0).mean() > 0.05      # 1 spp: 10% measured


def test_chunked_renderer_matches_jax(striped):
    jr, tr = striped["jr"], striped["tr"]
    near = check_ties(striped["ties"], SIZE, SIZE,
                      samples=range(len(STRIPES), 3 * len(STRIPES)))
    _compare(tr.state, jr.state, near, [(k, k) for k in FIELDS])
    assert int(tr.state["n_samples"]) == int(jr.state["n_samples"]) == 2
    assert tr.samples == jr.samples == 2
    np.testing.assert_array_equal(tr.state["pixel_count"].numpy(), 2.0)
    assert tr.raw_image.mean() > 0


def test_chunk_rows_must_divide():
    scene = ct.create_scene_from_preset("empty", 16, 16, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        ct.Renderer(scene, chunk_rows=5)
    assert ct.Renderer(scene, chunk_rows=16).chunk_rows is None
    assert ct.Renderer(scene, chunk_rows=4).chunk_rows == 4


def test_unweighted_image_matches_jax(striped, tmp_path):
    """The JAX renderer's state, resumed in the port from its checkpoint,
    gives the same images."""
    path = str(tmp_path / "jax.npz")
    striped["jr"].save_checkpoint(path)
    r = ct.Renderer(striped["tr"].scene, seed=0)
    r.load_checkpoint(path)
    for name in ("unweighted_image", "image", "raw_image"):
        np.testing.assert_array_equal(getattr(r, name),
                                      getattr(striped["jr"], name), name)
    assert r.unweighted_image.max() > 0


# ---- subsets and adaptive sampling -----------------------------------------

N_SELECT = SIZE * SIZE // 4


@pytest.fixture(scope="module")
def subset(striped):
    """The selection both packages make from the JAX chunked renderer's
    state, and one subset sample of it in each package."""
    jstate = striped["jr"].state
    tstate = _to_torch(jstate)
    want_sel = np.asarray(jax_renderer._make_adaptive_select(
        SIZE, SIZE, N_SELECT)(jstate))
    sel = port_renderer.adaptive_select(tstate, N_SELECT)
    js, ts = striped["jr"].scene, striped["tr"].scene
    with NearTies() as ties:
        want = jax.jit(lambda k, d, s: jax_render.render_sample_subset(
            k, d, s, SIZE, SIZE))(jax.random.key(SEED), js.data,
                                  jnp.asarray(want_sel))
        got = port_render.render_sample_subset(rng.key(SEED), ts.data, sel,
                                               SIZE, SIZE)
    return dict(ties=ties, jstate=jstate, tstate=tstate, want_sel=want_sel,
                sel=sel.numpy(), want=want, got=got)


def test_adaptive_scores_and_selection_match_jax(subset):
    want = jax_renderer._adaptive_scores(subset["jstate"])
    got = port_renderer._adaptive_scores(subset["tstate"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(subset["sel"], subset["want_sel"])
    assert subset["sel"].dtype == np.int32


def test_subset_sample_matches_jax(subset):
    near = check_ties(subset["ties"], SIZE, SIZE)
    ties = subset["ties"]
    np.testing.assert_array_equal(ties.torch_pixels[0], subset["want_sel"])
    _compare(subset["got"], subset["want"], near,
             [(k, k) for k in ("image", "weight", "unidirectional",
                               "uni_count")])
    count = subset["got"]["uni_count"].numpy().ravel()
    assert count.sum() == N_SELECT and set(np.flatnonzero(count)) == set(
        subset["want_sel"].tolist())


def test_selection_order_on_tied_scores():
    """Scores with many exact ties (zero-variance pixels and repeated
    values) across the cut: the port picks JAX's top_k pixels in JAX's
    order."""
    g = np.random.default_rng(3)
    h, w = 20, 30
    state = dict(
        summed_image=np.zeros((h, w, 3), np.float32),
        summed_weight=np.ones((h, w), np.float32),
        summed_sq=g.choice([0.0, 0.25, 0.5], size=(h, w)).astype(np.float32),
        pixel_count=np.full((h, w), 2.0, np.float32))
    want_scores = np.asarray(jax_renderer._adaptive_scores(
        {k: jnp.asarray(v) for k, v in state.items()}))
    for n in (1, 37, 250, 400, h * w):
        _, want = jax.lax.top_k(jnp.asarray(want_scores), n)
        got = port_renderer.adaptive_select(_to_torch(state), n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cut = np.sort(want_scores)[::-1][250]
    assert (want_scores == cut).sum() > 100      # the cut splits a tie


@pytest.mark.parametrize("chunk_rows,fraction", [(None, 0.25), (CHUNK, 0.5)])
def test_run_adaptive_sample(striped, subset, chunk_rows, fraction):
    """From the JAX renderer's state, one adaptive sample adds one count to
    exactly the pixels JAX selects; a striped renderer renders them in
    batches of chunk_rows * width (two here), and the counts' total grows
    by the selection's size."""
    r = ct.Renderer(striped["tr"].scene, seed=SEED, chunk_rows=chunk_rows)
    r.state = {k: v.clone() for k, v in subset["tstate"].items()}
    r.samples = 2
    n = int(SIZE * SIZE * fraction)
    want_sel = np.asarray(jax_renderer._make_adaptive_select(SIZE, SIZE, n)(
        subset["jstate"]))
    before = r.state["pixel_count"].numpy().copy()
    r.run_adaptive_sample(fraction=fraction)
    added = (r.state["pixel_count"].numpy() - before).ravel()
    np.testing.assert_array_equal(np.flatnonzero(added), np.sort(want_sel))
    assert added.sum() == n and set(added.tolist()) == {0.0, 1.0}
    assert int(r.state["n_samples"]) == 3 and r.samples == 3
    assert np.isfinite(r.raw_image).all() and r.raw_image.mean() > 0
    r.run_adaptive_sample(fraction=fraction)
    assert r.state["pixel_count"].sum() == 2 * SIZE * SIZE + 2 * n


def test_adaptive_checkpoint_round_trip(tmp_path):
    scene = ct.create_scene_from_preset("empty", 12, 12, device="cpu")
    a = ct.Renderer(scene, seed=5)
    for _ in range(2):
        a.run_sample()
    a.run_adaptive_sample(0.25)
    path = str(tmp_path / "adaptive.npz")
    a.save_checkpoint(path)
    b = ct.Renderer(scene, seed=0)
    b.load_checkpoint(path)
    for k in FIELDS:
        np.testing.assert_array_equal(a.state[k].numpy(), b.state[k].numpy())
    a.run_adaptive_sample(0.25)
    b.run_adaptive_sample(0.25)
    for k in FIELDS:
        np.testing.assert_array_equal(a.state[k].numpy(), b.state[k].numpy())
    np.testing.assert_array_equal(a.raw_image, b.raw_image)
