"""The port's threefry keys are bit for bit ``jax.random``'s (the JAX package
runs with jax_threefry_partitionable=True, the installed default)."""

import jax
import numpy as np
import pytest
import torch

from clive2_tpu_torch import rng

SEEDS = [0, 1, 42, 1234, 4321, 2**31 - 1, 2**32 - 1]


def _words(k):
    return np.asarray(jax.random.key_data(k)).tolist()


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key(seed):
    assert rng.key_data(rng.key(seed)) == _words(jax.random.key(seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 5, 77, 2**31, 2**32 - 1])
def test_fold_in(seed, data):
    want = jax.random.fold_in(jax.random.key(seed), np.uint32(data))
    assert rng.key_data(rng.fold_in(rng.key(seed), data)) == _words(want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 7])
def test_split(seed, num):
    want = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(seed), num)))
    got = rng.split(rng.key(seed), num).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (5,), (8, 2), (3, 4, 5), (1001, 2)])
@pytest.mark.parametrize("seed", [0, 1234, 2**32 - 1])
def test_uniform_bits(seed, shape):
    k = jax.random.key(seed)
    want = np.asarray(jax.random.uniform(k, shape, dtype=jax.numpy.float32))
    got = rng.uniform(rng.key(seed), shape).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_nesting_as_the_renderer_uses_it():
    """Renderer (fold_in sample) -> render_sample (split 3) -> trace
    (fold_in depth, split 3) -> uniform draws, and generate_light_rays'
    own split."""
    jk, tk = jax.random.key(1234), rng.key(1234)
    for sample in range(3):
        js = jax.random.fold_in(jk, np.uint32(sample))
        ts = rng.fold_in(tk, sample)
        jcam, jlight, jtrace = jax.random.split(js, 3)
        tcam, tlight, ttrace = rng.split(ts, 3)
        for depth in range(6):
            for jsub, tsub in zip(
                    jax.random.split(jax.random.fold_in(jtrace, depth), 3),
                    rng.split(rng.fold_in(ttrace, depth), 3)):
                want = np.asarray(jax.random.uniform(jsub, (9, 2)))
                got = rng.uniform(tsub, (9, 2)).numpy()
                np.testing.assert_array_equal(got, want)
        for jsub, tsub in zip(jax.random.split(jlight, 3),
                              rng.split(tlight, 3)):
            np.testing.assert_array_equal(
                rng.uniform(tsub, (17,)).numpy(),
                np.asarray(jax.random.uniform(jsub, (17,))))
        np.testing.assert_array_equal(
            rng.uniform(tcam, (4, 2)).numpy(),
            np.asarray(jax.random.uniform(jcam, (4, 2))))


def test_keys_are_tensors_on_their_device():
    k = rng.key(3, device="cpu")
    assert isinstance(k, torch.Tensor) and k.shape == (2,)
    assert rng.uniform(k, (4,)).device == k.device
    wrapped = rng.wrap_key_data(np.asarray([7, 9], np.uint32))
    assert rng.key_data(wrapped) == [7, 9]
