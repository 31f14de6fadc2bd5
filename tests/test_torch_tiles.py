"""Tile rendering over a mesh of ranks on the CPU: ``rng`` draws by lane,
``render_sample(tile=)``, ``parallel.mesh`` and ``Renderer(mesh=)``.

* a draw of given rows equals those rows of the full draw bit for bit, and
  the same rows of ``jax.random.uniform``;
* in one process, the tiles of a partition of the rows (2 tiles, and 3
  uneven ones; also inside a stripe) sum to the frame's sample of the same
  key, rtol 1e-5 / atol 1e-7 (float sums change order; measured at most
  2.4e-7 on the image and 1.9e-6 on weights near 1);
* 2 spawned ranks over gloo: ``Renderer(mesh=)`` equals a single-device
  ``Renderer`` on every rank (plain, ``chunk_rows=8``, and an adaptive
  sample) at the same tolerance, also where a rank gets no rows, the ranks
  hold identical states, a checkpoint written by rank 0 resumes bit for
  bit, and a rank holding other tables is refused;
* the port's single-device sample against the JAX package's
  ``make_sharded_render`` on the 8-device CPU mesh (Cornell 64x16, key 11),
  and the sum of its 3 uneven tiles against the same step, at the golden
  tolerance outside near-tie pixels.
"""

import os

import numpy as np
import pytest
import torch

import clive2_tpu_torch as ct
from clive2_tpu_torch import rng
from clive2_tpu_torch.integrator.render import render_sample, \
    trace_and_connect
from clive2_tpu_torch.parallel import (TileMesh, make_tile_mesh,
                                      resolve_device, tile_rows)
from clive2_tpu_torch.testing import spawn_ranks

torch.set_num_threads(2)

W, H, KEY = 64, 16, 11
SEED = 4
TOL = dict(rtol=1e-5, atol=1e-7)
OUTPUTS = ("image", "weight", "unidirectional")
RENDERERS = ("plain", "chunked", "adaptive")


@pytest.mark.parametrize("shape,rows", [((1000, 2), [0, 1, 999]),
                                        ((37,), list(range(5, 30))),
                                        ((9, 3, 2), [8, 0, 4, 4])])
@pytest.mark.parametrize("seed", [0, 1234])
def test_rows_of_a_draw_are_the_draw_s_rows(shape, rows, seed):
    import jax

    k = rng.key(seed)
    idx = torch.tensor(rows)
    full = rng.uniform(k, shape)
    part = rng.uniform(k, shape, rows=idx)
    assert part.shape == (len(rows),) + shape[1:]
    np.testing.assert_array_equal(part.numpy().view(np.uint32),
                                  full[idx].numpy().view(np.uint32))
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape))[rows]
    np.testing.assert_array_equal(part.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(
        rng.random_bits(k, shape, rows=idx).numpy(),
        rng.random_bits(k, shape)[idx].numpy())


def _mesh(rank, size):
    return TileMesh(group=None, rank=rank, size=size,
                    device=torch.device("cpu"))


@pytest.mark.parametrize("height", [1, 7, 16, 1080])
@pytest.mark.parametrize("size", [1, 2, 3, 8])
def test_tile_rows_partition_any_height(height, size):
    bands = [tile_rows(_mesh(r, size), height) for r in range(size)]
    assert bands[0][0] == 0
    for (a0, an), (b0, _) in zip(bands, bands[1:]):
        assert a0 + an == b0
    assert sum(n for _, n in bands) == height
    assert max(n for _, n in bands) - min(n for _, n in bands) <= 1


@pytest.fixture(scope="module")
def cornell():
    return ct.create_scene_from_preset("empty", W, H, device="cpu")


@pytest.fixture(scope="module")
def frame(cornell):
    return render_sample(rng.key(KEY), cornell.data, W, H)


def _summed(parts):
    return {k: sum(p[k] for p in parts) for k in parts[0]}


@pytest.mark.parametrize("bands", [[(0, 8), (8, 8)],
                                   [(0, 5), (5, 6), (11, 5)]])
def test_tiles_sum_to_the_frame(cornell, frame, bands):
    got = _summed([render_sample(rng.key(KEY), cornell.data, W, H, tile=b)
                   for b in bands])
    for k in OUTPUTS:
        np.testing.assert_allclose(got[k].numpy(), frame[k].numpy(), **TOL,
                                   err_msg=k)
    assert int(got["n_rays"]) == int(frame["n_rays"])


def test_tiles_of_a_stripe_sum_to_the_stripe(cornell):
    k = rng.fold_in(rng.key(KEY), 8)
    stripe = render_sample(k, cornell.data, W, H, row0=8, rows=8)
    got = _summed([render_sample(k, cornell.data, W, H, row0=8, rows=8,
                                 tile=b) for b in [(8, 3), (11, 5)]])
    for name in OUTPUTS:
        np.testing.assert_allclose(got[name].numpy(), stripe[name].numpy(),
                                   **TOL, err_msg=name)


def test_a_tile_refuses_what_needs_whole_frames(cornell):
    with pytest.raises(ValueError, match="tile"):
        trace_and_connect(rng.key(0), cornell.data, W, H, tile=(0, 8),
                          debug_per_strategy=True)
    with pytest.raises(ValueError, match="not inside"):
        render_sample(rng.key(0), cornell.data, W, H, row0=0, rows=8,
                      tile=(4, 8))


def test_mesh_on_another_device_than_the_scene_is_refused(cornell):
    for index in (0, 1):
        mesh = TileMesh(group=None, rank=0, size=1,
                        device=torch.device("cuda", index))
        with pytest.raises(ValueError, match="the mesh renders on cuda"):
            ct.Renderer(cornell, seed=0, mesh=mesh)


def test_resolve_device_names_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert resolve_device("cuda") == torch.device("cuda", 1)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    assert resolve_device("cuda") != resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_tile_mesh()


# ---- 2 ranks over gloo, spawned ---------------------------------------------

def _ranks(rank, size, workdir):
    """Each rank: the renderers of RENDERERS on the mesh, a checkpoint
    round trip, and a table check that must fail."""
    torch.set_num_threads(1)
    mesh = make_tile_mesh(n_devices=size, devices="cpu")
    scene = ct.create_scene_from_preset("empty", W, H, device="cpu")
    out = {}
    for name in RENDERERS:
        r = ct.Renderer(scene, seed=SEED, mesh=mesh,
                        chunk_rows=8 if name == "chunked" else None)
        r.run_sample()
        r.run_sample()
        if name == "adaptive":
            r.run_adaptive_sample(0.25)
        out.update({f"{name}/{k}": v.numpy() for k, v in r.state.items()})
    ck = os.path.join(workdir, "ck.npz")
    r.save_checkpoint(ck)
    resumed = ct.Renderer(scene, seed=SEED + 1, mesh=mesh)
    resumed.load_checkpoint(ck)
    r.run_sample()
    resumed.run_sample()
    for k in r.state:
        out[f"after/{k}"] = r.state[k].numpy()
        out[f"resumed/{k}"] = resumed.state[k].numpy()
    # one image row for two ranks: rank 0 renders none
    thin = ct.Renderer(ct.create_scene_from_preset("empty", 8, 1,
                                                   device="cpu"),
                       seed=SEED, mesh=mesh)
    thin.run_sample()
    out.update({f"thin/{k}": v.numpy() for k, v in thin.state.items()})
    try:
        mesh.check_replicated({"t": torch.full((3,), float(rank))}, "x")
    except RuntimeError:
        out["refused"] = True
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("mesh"))
    spawn_ranks(_ranks, 2, workdir, timeout=240)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(2)]


def test_mesh_ranks_hold_identical_states(ranks):
    a, b = ranks
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], k)
    assert a["refused"] and b["refused"]


@pytest.mark.parametrize("name", RENDERERS)
def test_mesh_renderer_equals_one_device(ranks, cornell, name):
    r = ct.Renderer(cornell, seed=SEED,
                    chunk_rows=8 if name == "chunked" else None)
    r.run_sample()
    r.run_sample()
    if name == "adaptive":
        r.run_adaptive_sample(0.25)
    for k, v in r.state.items():
        np.testing.assert_allclose(ranks[0][f"{name}/{k}"], v.numpy(), **TOL,
                                   err_msg=k)
    assert float(r.state["pixel_count"].sum()) == (
        2 * W * H + (W * H // 4 if name == "adaptive" else 0))


def test_mesh_with_more_ranks_than_rows(ranks):
    r = ct.Renderer(ct.create_scene_from_preset("empty", 8, 1, device="cpu"),
                    seed=SEED)
    r.run_sample()
    for k, v in r.state.items():
        np.testing.assert_allclose(ranks[0][f"thin/{k}"], v.numpy(), **TOL,
                                   err_msg=k)
    assert float(r.state["pixel_count"].sum()) == 8


def test_mesh_checkpoint_resumes_bit_for_bit(ranks):
    for k in ("summed_image", "summed_weight", "summed_unidirectional",
              "n_samples", "summed_sq", "pixel_count"):
        np.testing.assert_array_equal(ranks[0][f"resumed/{k}"],
                                      ranks[0][f"after/{k}"], k)
    assert int(ranks[0]["after/n_samples"]) == 4


# ---- the JAX package's sharded step ---------------------------------------

def test_one_device_sample_matches_jax_sharded(cornell, frame):
    import jax
    from jax.sharding import Mesh

    import clive2_tpu as c2
    from clive2_tpu.integrator.render import (make_sharded_render,
                                              render_sample_jit)
    from torch_parity import NearTies, assert_match, check_ties

    assert len(jax.devices()) == 8
    js = c2.create_scene_from_preset("empty", W, H)
    step = make_sharded_render(Mesh(np.array(jax.devices()), ("tiles",)),
                               W, H)
    want = {k: np.asarray(v) for k, v in step(jax.random.key(KEY),
                                              js.data).items()}
    # near ties from the JAX package's single-device program, which its
    # own test holds to the sharded one (tests/test_sharding.py)
    jax.clear_caches()
    with NearTies() as ties:
        render_sample_jit(jax.random.key(KEY), js.data, W, H)
        render_sample(rng.key(KEY), cornell.data, W, H)
    near = check_ties(ties, W, H)
    # the port's tiles (3 uneven bands), summed, against the same step
    tiles = _summed([render_sample(rng.key(KEY), cornell.data, W, H, tile=b)
                     for b in [(0, 5), (5, 6), (11, 5)]])
    for got in (frame, tiles):
        for k in ("image", "weight"):
            assert_match(got[k].numpy(), want[k], near, k)
        assert_match(got["unidirectional"].numpy(), want["unidirectional"],
                     np.zeros_like(near), "unidirectional")
