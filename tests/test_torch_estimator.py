"""The port's two BDPT estimators and its debug paths against the JAX package
on the CPU.

* The MIS chains: ``_mis_weight`` (the direct transcription of the
  reference's chain), ``_mis_weight_fast`` (the reference estimator's) and
  ``_mis_weight_correct`` (the corrected estimator's) against the JAX
  functions per (t, s) on random paths made with numpy from a seed: ``ok``
  equal, ``w`` and ``p_s`` within rtol 1e-5 / atol 1e-7.  The paths' cosines
  are kept above 0.4, where the two libraries' float32 dot products agree to
  a few ulps (XLA contracts them into FMAs).  And tests/test_mis.py's own
  check inside the port: the fast chain against the transcription.
* ``connect_paths(debug_per_strategy=True)`` on one sample of Cornell 16x16,
  under both estimators: every (t, s) image equals JAX's at the golden
  tolerance outside near-tie pixels (tests/torch_parity.py); the strategies
  sum to the non-debug outputs, which are bit-equal with debug on and off.
* ``unidirectional_image`` (all hits and first hit) on the JAX run's own
  path arrays, within rtol 1e-6.
* ``CLIVE2_REFERENCE_MIS``: the port and the JAX package render 24x24 /
  4 spp, seed 1234, and are held to tests/golden_cornell_refmis.npz at
  rtol 2e-4 / atol 1e-5, the port outside near-tie pixels (the
  unidirectional image on every pixel), the JAX run on every pixel: the JAX
  package reads the flag at import, so its three readers are patched and
  its compiled programs dropped, and the golden proves the patch took.  Its
  pieces: ``transmit_bounce`` without |o.n|, and the subpath lengths under
  the reference store rule.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu.constants as jax_constants
import clive2_tpu.integrator.connect as JC
import clive2_tpu.integrator.trace as JT
import clive2_tpu_torch as ct
from clive2_tpu import renderer as jax_renderer
from clive2_tpu.materials import default_materials
from clive2_tpu.ops import bsdf as jb
from clive2_tpu_torch import constants, rng
from clive2_tpu_torch.integrator import connect as TC
from clive2_tpu_torch.integrator import trace as TT
from clive2_tpu_torch.ops import bsdf as tb
from clive2_tpu_torch.ops.sampling import dot
from clive2_tpu_torch.scripts import diag_mis
from test_torch_ops import _both, _close, inputs  # noqa: F401
from torch_parity import REFMIS_BOUNDS, NearTies, assert_match, check_ties

torch.set_num_threads(2)

HERE = os.path.dirname(__file__)


@contextlib.contextmanager
def estimator(reference: bool):
    """Both packages on one estimator.  The port reads
    ``constants.REFERENCE_MIS`` at call time; the JAX package reads it at
    import in connect.py and trace.py and at call time in bsdf.py, so all
    three are patched, and its compiled programs are dropped before and
    after so that none outlives the patch."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (constants, jax_constants, JC, JT):
            mp.setattr(mod, "REFERENCE_MIS", reference)
        jax_renderer._make_step.cache_clear()
        jax.clear_caches()
        try:
            yield
        finally:
            jax_renderer._make_step.cache_clear()
            jax.clear_caches()


# ---- the MIS chains --------------------------------------------------------

D, N = 6, 257
CASES = [(2, 0), (3, 0), (6, 0), (2, 1), (2, 3), (4, 2), (6, 6), (2, 6),
         (1, 1), (1, 3), (1, 6)]
MAT = {k: np.asarray(v) for k, v in
       default_materials().to_pytree().items()}


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _paths(seed, steep=True):
    """Random camera and light paths [D, N].  ``steep``: every direction
    and normal within about 50 degrees of +-z, so that every cosine the
    chains take (a vertex's direction against its own or its neighbour's
    normal) is above 0.4; else tests/test_mis.py's unconstrained paths."""
    g = np.random.default_rng(seed)

    def vec(sign=1.0):
        if not steep:
            return _unit(g.normal(size=(D, N, 3)))
        z = np.where(g.uniform(size=(D, N, 1)) < 0.5, -1.0, 1.0) * sign
        return _unit(g.normal(size=(D, N, 3)) * 0.35 + z * [0, 0, 1])

    def path():
        return dict(
            origin=(g.normal(size=(D, N, 3)) * 3).astype(np.float32),
            direction=vec(), normal=vec(),
            l_importance=g.uniform(0.01, 2, (D, N)).astype(np.float32),
            c_importance=g.uniform(0.01, 2, (D, N)).astype(np.float32),
            tot_importance=g.uniform(0.01, 2, (D, N)).astype(np.float32),
            material=g.integers(0, 8, (D, N)).astype(np.int32))

    return path(), path()


def _chains(pkg, t, s, CV, LV, mat, jcos):
    """(_mis_weight, _mis_weight_fast, _mis_weight_correct) of one package
    ("jax" or "torch") on the same inputs."""
    C = JC if pkg == "jax" else TC
    conv = jnp.asarray if pkg == "jax" else torch.from_numpy
    CV, LV, mat = ({k: conv(v) for k, v in d.items()} for d in (CV, LV, mat))
    jcos_l, jcos_c = (conv(j) for j in jcos)
    cv = C._vstatic(CV, t - 1)
    lv = C._vstatic(LV, s - 1) if s else None
    synth = None
    if t == 1:                      # the synthetic sensor vertex
        synth = dict(cv, origin=lv["origin"] + 2.0,
                     direction=conv(np.tile(np.float32([[0, 0, 1]]), (N, 1))),
                     normal=conv(np.tile(np.float32([[0, 0.6, 0.8]]), (N, 1))),
                     material=conv(np.full(N, 7, np.int32)),
                     tot_importance=conv(np.ones(N, np.float32)))
        cv = synth
    pre = (C.precompute_mis(CV, LV, mat, D) if pkg == "jax"
           else C.precompute_mis(CV, LV, mat))
    p_s = cv["tot_importance"] * (lv["tot_importance"] if s else 1.0)
    kw = {}
    if s:
        delta = cv["origin"] - lv["origin"]
        d2 = (delta * delta).sum(-1)
        kw["Dx"] = (jnp.maximum(d2, 1e-30) if pkg == "jax"
                    else torch.clamp(d2, min=1e-30))
    fast_kw, corr_kw = dict(kw), dict(kw)
    if t == 1:
        spec = mat["type"][7] > 0
        spec = (jnp.broadcast_to(spec, (N,)) if pkg == "jax"
                else spec.expand(N))
        fast_kw.update(w_synth=abs((synth["direction"] * synth["normal"])
                                   .sum(-1)), spec_synth=spec)
        corr_kw.update(spec_synth=spec, t1_cam_c=pre["C"]["c"][0])
    if s:
        corr_kw.update(jcos_l=jcos_l, jcos_c=jcos_c)
    else:
        corr_kw.update(l0_override=pre["L"]["l"][0])
    return (C._mis_weight(t, s, CV, LV, cv, lv, mat, cv_synthetic=synth),
            C._mis_weight_fast(t, s, pre, p_s, **fast_kw),
            C._mis_weight_correct(t, s, pre, p_s, **corr_kw))


@pytest.mark.parametrize("t,s", CASES)
def test_mis_chains_match_jax(t, s):
    CV, LV = _paths(100 * t + s)
    jcos = np.random.default_rng(t + 10 * s).uniform(0.4, 1, (2, N)).astype(
        np.float32)
    want = _chains("jax", t, s, CV, LV, MAT, jcos)
    got = _chains("torch", t, s, CV, LV, MAT, jcos)
    for name, (gw, gp, gok), (ww, wp, wok) in zip(
            ("transcription", "fast", "correct"), got, want):
        np.testing.assert_array_equal(gok.numpy(), np.asarray(wok), name)
        assert gok.any(), name
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("t,s", CASES)
def test_fast_chain_matches_the_transcription(t, s):
    """tests/test_mis.py's check, in the port, on its unconstrained paths:
    the precomputed chain equals the direct transcription."""
    CV, LV = _paths(7 * t + s, steep=False)
    ones = np.ones((2, N), np.float32)
    (w_ref, ps_ref, ok_ref), (w_fast, ps_fast, ok_fast), _ = _chains(
        "torch", t, s, CV, LV, MAT, ones)
    np.testing.assert_array_equal(ok_ref.numpy(), ok_fast.numpy())
    np.testing.assert_allclose(ps_ref.numpy(), ps_fast.numpy(), rtol=1e-6)
    np.testing.assert_allclose(w_ref.numpy(), w_fast.numpy(), rtol=2e-4,
                               atol=1e-6)


# ---- one sample with per-strategy images -----------------------------------

SIZE16, SEED16 = 16, 31


def _merged_paths(pkg, key, data, size):
    """Camera and light rays of every pixel, traced as one wavefront:
    (cam_path, light_path) as render_sample splits them.  The port's are
    those of its MIS diagnostic (``scripts/diag_mis.py:merged_paths``)."""
    if pkg == "torch":
        return diag_mis.merged_paths(key, data, size, size)
    k_cam, k_light, k_trace = jax.random.split(key, 3)
    n = size * size
    cam_rays, _ = JT.generate_camera_rays(k_cam, data["camera"], size, size)
    light_rays = JT.generate_light_rays(k_light, data["lights"], data["mat"],
                                        n)
    merged = {k: jnp.concatenate([cam_rays[k], light_rays[k]])
              for k in cam_rays}
    fc = jnp.asarray(np.concatenate([np.ones(n, bool), np.zeros(n, bool)]))
    path = JT.trace_subpaths(k_trace, merged, data, from_camera=fc)
    half = lambda sl: dict(
        vertices={k: v[:, sl] for k, v in path["vertices"].items()},
        valid=path["valid"][:, sl], length=path["length"][sl])
    return half(slice(0, n)), half(slice(n, 2 * n))


def _jax_sample(key, data, size):
    cam_path, light_path = _merged_paths("jax", key, data, size)
    conn = JC.connect_paths(cam_path, light_path, data, size, size,
                            debug_per_strategy=True)
    return conn, cam_path, light_path["length"]


@pytest.fixture(scope="module", params=["default", "reference"])
def strategies(request):
    """One sample of Cornell 16x16 with per-strategy images, JAX and port,
    under the estimator the parameter names; the port's connection again
    without the debug images."""
    js = c2.create_scene_from_preset("empty", SIZE16, SIZE16)
    ts = ct.create_scene_from_preset("empty", SIZE16, SIZE16, device="cpu")
    with estimator(request.param == "reference"):
        with NearTies() as ties:
            jconn, jcam, jlight_len = jax.jit(
                functools.partial(_jax_sample, size=SIZE16))(
                    jax.random.key(SEED16), js.data)
            cam_path, light_path = _merged_paths(
                "torch", rng.key(SEED16), ts.data, SIZE16)
            conn = TC.connect_paths(cam_path, light_path, ts.data, SIZE16,
                                    SIZE16, debug_per_strategy=True)
        plain = TC.connect_paths(cam_path, light_path, ts.data, SIZE16,
                                 SIZE16)
    return dict(ties=ties, jconn=jconn, conn=conn, plain=plain,
                jcam=jcam, jlight_len=np.asarray(jlight_len),
                cam_path=cam_path, light_len=light_path["length"].numpy(),
                reference=request.param == "reference")


def test_per_strategy_images_match_jax(strategies):
    bounds = REFMIS_BOUNDS if strategies["reference"] else {}
    near = check_ties(strategies["ties"], SIZE16, SIZE16, **bounds)
    want = strategies["jconn"]["per_strategy"]
    got = strategies["conn"]["per_strategy"]
    assert sorted(got) == sorted(want) and len(got) == 41
    for ts_, images in want.items():
        for kind, img in images.items():
            assert_match(got[ts_][kind].numpy(), img, near, f"{ts_} {kind}")
    total = sum(float(v["weighted"].sum()) for v in got.values())
    assert total > 0


def test_strategies_sum_to_the_outputs(strategies):
    conn, plain = strategies["conn"], strategies["plain"]
    per = conn["per_strategy"]
    for name, t1, key, shape in (
            ("contribution", False, "weighted", (-1, 3)),
            ("contrib_weight_sum", False, "weight", (-1,)),
            ("light_image", True, "weighted", None),
            ("light_weight_image", True, "weight", None)):
        parts = sum(v[key] for (t, s), v in per.items() if (t == 1) == t1)
        want = conn[name]
        parts = parts if shape is None else parts.reshape(shape)
        np.testing.assert_allclose(parts.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        # the debug images change nothing the renderer reads
        assert torch.equal(plain[name], want), name
    assert int(plain["n_rays"]) == int(conn["n_rays"])
    assert "per_strategy" not in plain


@pytest.mark.parametrize("all_hits", [True, False])
def test_unidirectional_image_matches_jax(strategies, all_hits):
    """Both packages' estimate from the JAX run's own camera path."""
    jcam = strategies["jcam"]
    want = JT.unidirectional_image(jcam, all_hits=all_hits)
    path = dict(vertices={k: torch.from_numpy(np.array(v))
                          for k, v in jcam["vertices"].items()},
                valid=torch.from_numpy(np.array(jcam["valid"])))
    got = TT.unidirectional_image(path, all_hits=all_hits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert float(got.sum()) > 0


def test_subpath_lengths_match_jax(strategies):
    """Subpath lengths under the estimator's store rule (the reference's
    stores a vertex only when the next bounce succeeds), equal to JAX's on
    every lane whose extension casts agree."""
    ties = strategies["ties"]
    n = SIZE16 * SIZE16
    tied = np.zeros(2 * n, bool)
    for a, b in zip(ties.jax_casts[:6], ties.torch_casts[:6]):
        tied |= a != b
    got = np.concatenate([strategies["cam_path"]["length"].numpy(),
                          strategies["light_len"]])
    want = np.concatenate([np.asarray(strategies["jcam"]["length"]),
                           strategies["jlight_len"]])
    np.testing.assert_array_equal(got[~tied], want[~tied])
    assert tied.mean() < 0.01 and got.max() > 1


# ---- the reference estimator -----------------------------------------------

def test_reference_estimator_golden():
    size, spp = 24, 4
    js = c2.create_scene_from_preset("empty", size, size)
    ts = ct.create_scene_from_preset("empty", size, size, device="cpu")
    with estimator(True):
        jr = c2.Renderer(js, seed=1234)
        tr = ct.Renderer(ts, seed=1234)
        with NearTies() as ties:
            for _ in range(spp):
                jr.run_sample()
                tr.run_sample()
    near = check_ties(ties, size, size, **REFMIS_BOUNDS)
    g = np.load(os.path.join(HERE, "golden_cornell_refmis.npz"))
    none = np.zeros_like(near)
    for field, key, tied in (("summed_image", "image", True),
                             ("summed_weight", "weight", True),
                             ("summed_unidirectional", "uni", False)):
        assert_match(jr.state[field], g[key], none, f"JAX {key}")
        assert_match(tr.state[field].numpy(), g[key],
                     near if tied else none, f"port {key}")


def test_transmit_bounce_under_the_reference_estimator(inputs):  # noqa: F811
    """The reference's transmit weight leaves out |o.n| (the JAX package
    reads the flag in bsdf.py at call time)."""
    (jn, tn), (jwi, twi), (jm, tm), (ja, ta), (jni, tni) = (
        _both(inputs[k]) for k in ("n", "wi", "m", "alpha", "ni"))
    jno, tno = _both(np.where(inputs["ni"] == 1.0, 1.5, 1.0)
                     .astype(np.float32))
    default = tb.transmit_bounce(twi, tn, tm, tni, tno, ta)
    with estimator(True):
        got = tb.transmit_bounce(twi, tn, tm, tni, tno, ta)
        want = jb.transmit_bounce(jwi, jn, jm, jni, jno, ja, True)
    _close(got, want)
    np.testing.assert_allclose(
        (got[1] * dot(got[0], tn).abs()).numpy(), default[1].numpy(),
        rtol=1e-6, atol=1e-7)
    assert not torch.equal(got[1], default[1])
