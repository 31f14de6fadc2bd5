"""The per-cast Morton sort and the connection cast's knobs, against the JAX
package on the CPU.

* ``morton_key`` equals ``traverse_pallas2._morton_key`` bit for bit on
  coherent, incoherent and degenerate rays (rays starting inside the box or
  on its faces, rays that miss it, axis-parallel directions, zero and
  negative-zero components, the zero vector), inactive rays included, and
  ``light_gen_key`` equals the JAX package's.  The JAX functions run op by
  op (not jitted), so neither side contracts a multiply and an add.
* A sorted cast returns the same (id, t, u, v) as an unsorted one on each
  traversal table's plain version (BVH2's gather walk, BVH8, stream1,
  stream2), closest-hit, capped, and any-hit (compared by verdict), and the
  traversal is handed its rays in key order.  ``sort=None`` sorts exactly
  the streaming tables' casts; brute and the gather walk ignore ``sort``.
* ``CLIVE2_CONNECT_K`` gives the same connection outputs as the full cast,
  in both packages; ``CLIVE2_ANY_HIT=0`` renders the JAX package's sample
  under the same knob; the sort knobs read the environment at call time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import clive2_tpu as c2
import clive2_tpu_torch as ct
from clive2_tpu import renderer as jax_renderer
from clive2_tpu.geometry import TriangleSoup as JaxSoup
from clive2_tpu.integrator import connect as jax_connect
from clive2_tpu.integrator.trace import light_gen_key as jax_light_gen_key
from clive2_tpu.ops.traverse_pallas2 import _morton_key
from clive2_tpu_torch import rng
from clive2_tpu_torch import scene as port_scene
from clive2_tpu_torch.geometry import TriangleSoup as TorchSoup
from clive2_tpu_torch.integrator import connect, render, trace
from clive2_tpu_torch.ops import (intersect, traverse_bvh2, traverse_stream,
                                  traverse_stream2, traverse_wide)
from test_torch_slice import FIELDS, SEED, H, W, _bvh_scene
from torch_parity import NearTies, assert_match, check_ties

torch.set_num_threads(2)

LO = np.array([-2.0, -1.0, -3.0], np.float32)
HI = np.array([2.0, 3.0, 1.0], np.float32)
N = 4096


def _rays(kind, seed=5):
    """[N, 3] origins and directions of one ray set, and an active mask."""
    g = np.random.default_rng(seed)
    if kind == "coherent":          # a pinhole outside the box
        o = np.tile(np.float32([0.5, 1.0, 8.0]), (N, 1))
        d = np.stack([g.uniform(-0.3, 0.3, N), g.uniform(-0.3, 0.3, N),
                      -np.ones(N)], 1)
    elif kind == "incoherent":
        o = g.uniform(1.5 * LO, 1.5 * HI, (N, 3))
        d = g.normal(size=(N, 3))
    else:                           # degenerate cases, a block of each
        o = g.uniform(LO, HI, (N, 3))           # inside the box
        d = g.normal(size=(N, 3))
        blk = N // 8
        o[blk:2 * blk] = HI + 1.0               # outside, pointing away:
        d[blk:2 * blk] = np.abs(d[blk:2 * blk])  # misses the box
        d[2 * blk:3 * blk, 1:] = 0.0            # axis-parallel
        d[3 * blk:4 * blk, 2] = 0.0             # one zero component
        d[4 * blk:5 * blk, 0] = -0.0
        d[5 * blk:5 * blk + 16] = 0.0           # the zero vector
        o[6 * blk:7 * blk, 0] = LO[0]           # on a face of the box
        o[7 * blk:, 1] = HI[1] + 2.0            # above it, axis-parallel
        d[7 * blk:] = np.float32([0.0, -1.0, 0.0])
    norm = np.linalg.norm(d, axis=1, keepdims=True)
    d = np.where(norm > 0, d / np.maximum(norm, 1e-30), d)
    active = g.uniform(size=N) < 0.75
    return o.astype(np.float32), d.astype(np.float32), active


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["coherent", "incoherent", "degenerate"])
def test_morton_key_matches_jax_bit_for_bit(kind, masked):
    o, d, active = _rays(kind)
    want = np.asarray(_morton_key(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(LO), jnp.asarray(HI),
        active=jnp.asarray(active) if masked else None)).astype(np.int64)
    got = intersect.morton_key(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(LO),
        torch.from_numpy(HI),
        active=torch.from_numpy(active) if masked else None)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the set reaches many cells, and inactive rays key last
    assert len(np.unique(want)) > N // 8
    if masked:
        assert (want[~active] == 0xFFFFFFFF).all()


def test_cell_index_converts_as_xla():
    """NaN and negative values to cell 0, overflow to the top cell."""
    x = np.float32([np.nan, -5.0, -0.5, 0.0, 3.7, 1023.9, 1024.0, 1e20,
                    np.inf, -np.inf])
    want = np.asarray(jnp.clip(jnp.asarray(x).astype(jnp.uint32), 0, 1023))
    got = intersect.cell_index(torch.from_numpy(x), 1024)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _cornell_lights(n):
    from clive2_tpu.integrator.trace import generate_light_rays

    data = c2.create_scene_from_preset("empty", 8, 8).data
    rays = generate_light_rays(jax.random.key(3), data["lights"],
                               data["mat"], n)
    return np.array(rays["origin"]), np.array(rays["direction"])


@pytest.mark.parametrize("kind", ["cornell_emitter", "random", "one_point"])
def test_light_gen_key_matches_jax_bit_for_bit(kind):
    g = np.random.default_rng(8)
    if kind == "cornell_emitter":   # flat: one axis spans zero
        o, d = _cornell_lights(N)
    else:
        o = g.uniform(-4, 4, (N, 3)).astype(np.float32)
        d = g.normal(size=(N, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        if kind == "one_point":
            o[:] = o[0]
    want = np.asarray(jax_light_gen_key(jnp.asarray(o), jnp.asarray(d)))
    got = trace.light_gen_key(torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert len(np.unique(want)) > N // 16


# ---- sorted casts on each traversal table's plain version -----------------

TABLES = {"bvh2": traverse_bvh2, "wide": traverse_wide,
          "stream": traverse_stream, "stream2": traverse_stream2}


@pytest.fixture(scope="module")
def scenes():
    """The icosphere BVH scene on the CPU with each traversal table."""
    base = _bvh_scene(ct, TorchSoup, device="cpu")
    rows = {k: v.numpy() for k, v in base.data["bvh"].items()}
    n_world = int((base.data["tri"]["is_camera"] == 0).sum())
    out = {None: base.data}
    for name in TABLES:
        data = {k: v for k, v in base.data.items()
                if k not in port_scene.PACKERS}
        data.update(port_scene.to_device(port_scene.traversal_tables(
            rows, n_world, cuda=False, traversal=name), "cpu"))
        out[name] = data
    return out


def _cast_rays(data):
    """Camera rays of the scene, then rays from inside its root box in
    every direction; 80% active, random caps."""
    cam, _ = trace.generate_camera_rays(rng.key(4), data["camera"], 32, 32)
    g = torch.Generator().manual_seed(6)
    lo = data["bvh"]["node_packed"][0, 0:3]
    hi = data["bvh"]["node_packed"][0, 3:6]
    o = lo + (hi - lo) * torch.rand(2048, 3, generator=g)
    d = torch.randn(2048, 3, generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    origin = torch.cat([cam["origin"], o])
    direction = torch.cat([cam["direction"], d])
    n = origin.shape[0]
    active = torch.rand(n, generator=g) < 0.8
    t_max = torch.rand(n, generator=g) * 8
    return origin, direction, active, t_max


@pytest.fixture
def received(monkeypatch):
    """Records the origins each traversal is handed."""
    got = {}
    for name, module in TABLES.items():
        fn = getattr(module, f"intersect_{name}")

        def wrap(origin, *a, _fn=fn, _name=name, **k):
            got.setdefault(_name, []).append(origin)
            return _fn(origin, *a, **k)

        monkeypatch.setattr(module, f"intersect_{name}", wrap)
    return got


@pytest.mark.parametrize("variant", ["closest", "capped", "any_hit"])
@pytest.mark.parametrize("table", list(TABLES))
def test_sorted_cast_equals_unsorted(scenes, received, table, variant):
    data = scenes[table]
    origin, direction, active, t_max = _cast_rays(data)
    kw = dict(active=active, t_max=None if variant == "closest" else t_max,
              any_hit=variant == "any_hit")
    want = intersect.intersect_scene(origin, direction, data, sort=False,
                                     **kw)
    got = intersect.intersect_scene(origin, direction, data, sort=True, **kw)
    if variant == "any_hit":
        np.testing.assert_array_equal((got[0] >= 0).numpy(),
                                      (want[0] >= 0).numpy())
        hit = (got[0] >= 0) & (got[0] == want[0])
        assert hit.sum() > 100
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a[hit].numpy(), b[hit].numpy())
    else:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        assert (want[0] >= 0).sum() > 500
    # the sorted call handed the traversal its rays in key order
    first, second = received[table]
    assert torch.equal(first, origin)
    key = intersect.morton_key(origin, direction, data[table]["lo"],
                               data[table]["hi"], active)
    order = intersect.ray_order(key)
    assert torch.equal(second, origin[order])
    assert bool((key[order][1:] >= key[order][:-1]).all())


@pytest.mark.parametrize("table", [None, *TABLES])
def test_default_sorts_exactly_the_streaming_casts(scenes, received, table):
    data = scenes[table]
    origin, direction, active, _ = _cast_rays(data)
    intersect.intersect_scene(origin, direction, data, active=active,
                              sort=None)
    given = received["bvh2" if table is None else table][0]
    assert torch.equal(given, origin) == (table not in ("stream",
                                                        "stream2"))


def test_brute_and_the_gather_walk_ignore_sort(scenes, received):
    """Neither has a table whose root box could key a sort: both take the
    rays in the caller's order and give the same hits."""
    brute = ct.create_scene_from_preset("empty", 8, 8, device="cpu").data
    for data in (brute, scenes[None]):
        origin, direction, active, t_max = _cast_rays(data)
        a = intersect.intersect_scene(origin, direction, data, active=active,
                                      t_max=t_max, sort=True)
        b = intersect.intersect_scene(origin, direction, data, active=active,
                                      t_max=t_max, sort=False)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert all(torch.equal(o, received["bvh2"][0]) for o in received["bvh2"])


def test_tables_keep_the_root_box(scenes):
    box = scenes[None]["bvh"]["node_packed"][0]
    for name in TABLES:
        assert torch.equal(scenes[name][name]["lo"], box[0:3])
        assert torch.equal(scenes[name][name]["hi"], box[3:6])


@pytest.mark.parametrize("value,want", [(None, None), ("auto", None),
                                        ("", None), ("0", False),
                                        ("1", True)])
def test_sort_knobs_read_at_call_time(monkeypatch, value, want):
    for name in ("CLIVE2_TRACE_SORT", "CLIVE2_CONNECT_SORT"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
        assert trace.sort_knob(name) is want


def test_connection_knobs_read_at_call_time(monkeypatch):
    monkeypatch.delenv("CLIVE2_ANY_HIT", raising=False)
    monkeypatch.delenv("CLIVE2_CONNECT_K", raising=False)
    assert connect.any_hit_casts() and connect.connect_k() == 0
    monkeypatch.setenv("CLIVE2_ANY_HIT", "0")
    monkeypatch.setenv("CLIVE2_CONNECT_K", "4")
    assert not connect.any_hit_casts() and connect.connect_k() == 4


# ---- the connection cast's knobs -------------------------------------------

CONN_KEYS = ("contribution", "contrib_weight_sum", "light_image",
             "light_weight_image", "n_rays")


@pytest.fixture(scope="module")
def port_paths():
    """The camera and light subpaths one raster sample of the icosphere
    scene hands the port's connection."""
    data = _bvh_scene(ct, TorchSoup, device="cpu").data
    got = {}
    orig = render.connect_paths

    def grab(cam_path, light_path, *a, **k):
        got.update(cam=cam_path, light=light_path)
        return orig(cam_path, light_path, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(render, "connect_paths", grab)
        render.render_sample(rng.key(SEED), data, W, H, order="raster")
    return data, got["cam"], got["light"]


@pytest.mark.parametrize("k", [1, 4])
def test_connect_k_equals_the_full_cast(port_paths, monkeypatch, k):
    data, cam_path, light_path = port_paths
    casts = []
    orig = connect.intersect_scene

    def count(*a, **kw):
        casts.append(kw["active"].sum())
        return orig(*a, **kw)

    monkeypatch.setattr(connect, "intersect_scene", count)
    monkeypatch.delenv("CLIVE2_CONNECT_K", raising=False)
    want = connect.connect_paths(cam_path, light_path, data, W, H)
    monkeypatch.setenv("CLIVE2_CONNECT_K", str(k))
    got = connect.connect_paths(cam_path, light_path, data, W, H)
    for name in CONN_KEYS:
        assert torch.equal(got[name], want[name]), name
    # the compacted cast, then the overflow cast of the pixels with more
    # than k active pairs, the two together casting every active ray once
    assert len(casts) == 3 and int(casts[1] + casts[2]) == int(casts[0])
    assert 0 < int(casts[2]) < int(casts[0])


def test_connect_k_equals_the_full_cast_in_jax(monkeypatch):
    """The JAX package's own compacted cast (its CONNECT_K, read at import)
    on the JAX sample's subpaths."""
    from clive2_tpu.integrator.trace import (generate_camera_rays,
                                             generate_light_rays,
                                             trace_subpaths)

    js = _bvh_scene(c2, JaxSoup)
    k_cam, k_light, k_trace = jax.random.split(jax.random.key(SEED), 3)
    cam_rays, _ = generate_camera_rays(k_cam, js.data["camera"], W, H)
    light_rays = generate_light_rays(k_light, js.data["lights"],
                                     js.data["mat"], W * H)
    merged = jax.tree.map(lambda a, b: jnp.concatenate([a, b]), cam_rays,
                          light_rays)
    fc = jnp.arange(2 * W * H) < W * H
    path = jax.jit(trace_subpaths)(k_trace, merged, js.data, fc)
    n = W * H
    half = lambda sl: dict(
        vertices=jax.tree.map(lambda a: a[:, sl], path["vertices"]),
        valid=path["valid"][:, sl], length=path["length"][sl],
        n_rays=path["n_rays"])
    cam_path, light_path = half(slice(0, n)), half(slice(n, 2 * n))
    outs = {}
    for k in (0, 4):
        monkeypatch.setattr(jax_connect, "CONNECT_K", k)
        outs[k] = jax_connect.connect_paths(cam_path, light_path, js.data,
                                            W, H)
    for name in CONN_KEYS:
        np.testing.assert_array_equal(np.asarray(outs[4][name]),
                                      np.asarray(outs[0][name]), name)


@pytest.fixture(scope="module")
def closest_hit_sample():
    """One sample of the icosphere scene with closest-hit connection casts
    (CLIVE2_ANY_HIT=0; the JAX package reads it at import, so its flag is
    patched and its step traced anew), raster order on both sides."""
    js = _bvh_scene(c2, JaxSoup)
    ts = _bvh_scene(ct, TorchSoup, device="cpu")
    flags = []
    orig = connect.intersect_scene

    def flag(*a, **kw):
        flags.append((kw["any_hit"], kw["t_max"]))
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_connect, "ANY_HIT_CASTS", False)
        mp.setattr(connect, "intersect_scene", flag)
        mp.setenv("CLIVE2_ANY_HIT", "0")
        jax_renderer._make_step.cache_clear()
        jax.clear_caches()
        jr = c2.Renderer(js, seed=SEED)
        tr = ct.Renderer(ts, seed=SEED)
        with NearTies() as ties:
            jr.run_sample()
            tr.run_sample()
    jax_renderer._make_step.cache_clear()
    jax.clear_caches()
    return dict(ties=ties, flags=flags,
                want={k: np.asarray(jr.state[k]) for k in FIELDS},
                got={k: tr.state[k].numpy() for k in FIELDS})


def test_closest_hit_connection_matches_jax(closest_hit_sample):
    """Cast ids compared on every ray, the connection cast's too (it is
    closest-hit), and the sample at the golden tolerance outside the
    near-tie pixels."""
    s = closest_hit_sample
    (any_hit, t_max), = s["flags"]
    assert not any_hit
    near = check_ties(s["ties"], W, H)
    for k in FIELDS:
        mask = np.zeros_like(near) if k == "summed_unidirectional" else near
        assert_match(s["got"][k], s["want"][k], mask, k)
    assert s["got"]["summed_image"].mean() > 0


def test_closest_hit_caps_lie_beyond_the_target(port_paths, monkeypatch):
    """Under CLIVE2_ANY_HIT=0 the caps are the any-hit caps' targets
    times 1.001 plus 1e-4; by default they lie below the target."""
    data, cam_path, light_path = port_paths
    caps = {}
    orig = connect.intersect_scene

    def grab(*a, **kw):
        caps[kw["any_hit"]] = kw["t_max"]
        return orig(*a, **kw)

    monkeypatch.setattr(connect, "intersect_scene", grab)
    monkeypatch.delenv("CLIVE2_ANY_HIT", raising=False)
    connect.connect_paths(cam_path, light_path, data, W, H)
    monkeypatch.setenv("CLIVE2_ANY_HIT", "0")
    connect.connect_paths(cam_path, light_path, data, W, H)
    target = caps[True] / (1.0 - 1e-3)
    fin = torch.isfinite(target)
    assert fin.float().mean() > 0.5
    torch.testing.assert_close(caps[False][fin],
                               target[fin] * 1.001 + 1e-4)
