"""The port's elementwise ops against the JAX package on identical inputs:
sampling, the GGX BSDF suite, gather and the 3x3 filter.  Tolerance
rtol 1e-5, atol 1e-6 (float32; the two libraries round transcendentals and
fused multiply-adds differently by an ulp or so)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clive2_tpu.ops import bsdf as jb
from clive2_tpu.ops import filters as jf
from clive2_tpu.ops import gather as jg
from clive2_tpu.ops import sampling as js
from clive2_tpu_torch.ops import bsdf as tb
from clive2_tpu_torch.ops import filters as tf
from clive2_tpu_torch.ops import gather as tg
from clive2_tpu_torch.ops import sampling as ts

torch.set_num_threads(2)

N = 512
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def _unit(rng, n=N):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture
def inputs():
    rng = np.random.default_rng(11)
    n = _unit(rng)
    wi = _unit(rng)
    wi = np.where((wi * n).sum(1, keepdims=True) < 0, -wi, wi)  # same side
    m = _unit(rng)
    m = np.where((m * n).sum(1, keepdims=True) < 0, -m, m)
    return dict(
        n=n, wi=wi, m=m, v=rng.normal(size=(N, 3)).astype(np.float32) * 4,
        rand=rng.uniform(size=(N, 2)).astype(np.float32),
        alpha=np.where(rng.uniform(size=N) < 0.3, 0.0,
                       rng.uniform(0.05, 0.8, N)).astype(np.float32),
        ni=np.where(rng.uniform(size=N) < 0.5, 1.0, 1.5).astype(np.float32),
        uv=rng.uniform(0, 0.5, (N, 2)).astype(np.float32),
        tri=rng.normal(size=(3, N, 3)).astype(np.float32),
    )


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.asarray(x))


def test_sampling(inputs):
    (jn, tn), (jv, tv), (jr, tr), (ja, ta) = (
        _both(inputs[k]) for k in ("n", "v", "rand", "alpha"))
    _close(ts.dot(tv, tn), js.dot(jv, jn))
    _close(ts.cross(tv, tn), jnp.cross(jv, jn))
    _close(ts.normalize(tv), js.normalize(jv))
    _close(ts.orthonormal(tn), js.orthonormal(jn))
    x, y = ts.orthonormal(tn)
    jx, jy = js.orthonormal(jn)
    _close(ts.random_hemisphere_cosine(x, y, tn, tr),
           js.random_hemisphere_cosine(jx, jy, jn, jr))
    _close(ts.random_hemisphere_uniform(x, y, tn, tr),
           js.random_hemisphere_uniform(jx, jy, jn, jr))
    _close(ts.ggx_sample(tn, tr, ta), js.ggx_sample(jn, jr, ja))
    (j0, t0), (j1, t1), (j2, t2) = (_both(inputs["tri"][i]) for i in range(3))
    _close(ts.sample_triangle_uniform(t0, t1, t2, tr),
           js.sample_triangle_uniform(j0, j1, j2, jr))


def test_pi_constants_round_like_jax():
    assert np.float32(ts.PI) == np.asarray(js.PI)
    assert np.float32(ts.INV_PI) == np.asarray(jnp.float32(1.0) / js.PI)
    assert np.float32(ts.INV_2PI) == np.asarray(1.0 / (2.0 * js.PI))


def test_bsdf(inputs):
    (jn, tn), (jwi, twi), (jm, tm), (ja, ta), (jni, tni), (juv, tuv) = (
        _both(inputs[k]) for k in ("n", "wi", "m", "alpha", "ni", "uv"))
    jno, tno = _both(np.where(inputs["ni"] == 1.0, 1.5, 1.0)
                     .astype(np.float32))
    jr, tr = _both(inputs["rand"])
    _close(tb.specular_reflection(twi, tm), jb.specular_reflection(jwi, jm))
    _close(tb.ggx_transmit_direction(twi, tm, tni, tno),
           jb.ggx_transmit_direction(jwi, jm, jni, jno))
    _close(tb.fresnel(twi, tm, tni, tno), jb.fresnel(jwi, jm, jni, jno))
    _close(tb.ggx_g1(twi, tm, ta), jb.ggx_g1(jwi, jm, ja))
    _close(tb.ggx_g(twi, tn, tm, tn, ta), jb.ggx_g(jwi, jn, jm, jn, ja))
    _close(tb.ggx_d(tm, tn, ta), jb.ggx_d(jm, jn, ja))
    _close(tb.reflect_jacobian(tm, twi), jb.reflect_jacobian(jm, jwi))
    wo = tb.ggx_transmit_direction(twi, tm, tni, tno)
    jwo = jb.ggx_transmit_direction(jwi, jm, jni, jno)
    _close(tb.transmit_jacobian(twi, wo, tni, tno),
           jb.transmit_jacobian(jwi, jwo, jm, jni, jno))
    _close(tb.ggx_brdf_reflect(twi, tn, tm, tn, tni, tno, ta),
           jb.ggx_brdf_reflect(jwi, jn, jm, jn, jni, jno, ja))
    _close(tb.ggx_brdf_transmit(twi, wo, tm, tn, tni, tno, ta),
           jb.ggx_brdf_transmit(jwi, jwo, jm, jn, jni, jno, ja))
    _close(tb.interpolate_normal(tn, tm, twi, tuv[:, 0], tuv[:, 1]),
           jb.interpolate_normal(jn, jm, jwi, juv[:, 0], juv[:, 1]))
    _close(tb.diffuse_bounce(twi, tn, tr),
           jb.diffuse_bounce(jwi, jn, True, jr))
    _close(tb.reflect_bounce(twi, tn, tm, tni, tno, ta),
           jb.reflect_bounce(jwi, jn, jm, jni, jno, ja, True))
    _close(tb.transmit_bounce(twi, tn, tm, tni, tno, ta),
           jb.transmit_bounce(jwi, jn, jm, jni, jno, ja, True))


@pytest.mark.parametrize("rows", [3, 600])   # one-hot and take paths in JAX
def test_gather_rows_keeps_the_one_hot_semantics(rows):
    rng = np.random.default_rng(12)
    table = rng.normal(size=(rows, 4)).astype(np.float32)
    idx = rng.integers(0, rows, 50).astype(np.int32)
    want = jg.gather_rows(jnp.asarray(table), jnp.asarray(idx))
    got = tg.gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ints = torch.arange(rows, dtype=torch.int32)
    out = tg.gather_rows(ints, torch.tensor([-1, 0, rows, rows - 1]))
    assert out.tolist() == [0, 0, 0, rows - 1]     # out of range -> zero row
    if rows <= jg.ONEHOT_MAX_ROWS:
        want = jg.gather_rows(jnp.asarray(ints.numpy()),
                              jnp.asarray([-1, 0, rows, rows - 1]))
        assert np.asarray(want).tolist() == out.tolist()


@pytest.mark.parametrize("size", [(8, 8), (13, 7)])
def test_filter(size):
    w, h = size
    rng = np.random.default_rng(13)
    import clive2_tpu_torch as ct

    cam = {k: np.asarray(v, np.float32) for k, v in
           ct.create_scene_from_preset("empty", w, h, device="cpu").camera
           .to_pytree()
           .items()}
    jcam = {k: jnp.asarray(v) for k, v in cam.items()}
    tcam = {k: torch.from_numpy(v) for k, v in cam.items()}
    n = w * h
    pix = np.arange(n, dtype=np.int32)
    off = rng.uniform(size=(n, 2)).astype(np.float32)
    xn = ((pix % w) + off[:, 0] - 0.5 * w) / w
    yn = ((pix // w) + off[:, 1] - 0.5 * h) / h
    pos = (cam["center"] + (xn * cam["phys_width"])[:, None] * cam["dx"]
           + (yn * cam["phys_height"])[:, None] * cam["dy"]).astype(np.float32)
    jw = jf.filter_weights(jnp.asarray(pos), jnp.asarray(pix), jcam, w, h)
    tw = tf.filter_weights(torch.from_numpy(pos), torch.from_numpy(pix), tcam,
                           w, h)
    _close(tw, jw)
    contrib = rng.uniform(size=(n, 3)).astype(np.float32)
    cws = rng.uniform(size=n).astype(np.float32)
    want = jf.finalize_samples(jnp.asarray(contrib), jw, jnp.asarray(cws), w,
                               h)
    got = tf.finalize_samples(torch.from_numpy(contrib), tw,
                              torch.from_numpy(cws), w, h)
    _close(got, want)
