"""Kernel tests that need an NVIDIA GPU (marker ``cuda``); without a card
they skip.  The card's machine has no JAX, so run them there without the
suite's conftest, with the port's statistical oracles:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py tests/test_torch_oracles.py

Each kernel must match its plain PyTorch version on every ray (ids; t, u, v
to 1e-6; built with --fmad=false both round alike; the fat-leaf, streaming
and wide kernels' any-hit ids too, since each stops where its plain version
does), each kernel of the queued fat-leaf traversal its plain step on the
same state, and a small render on the card must match the same render on
the CPU.  Camera moves put the brute and BVH2 kernels on moved sensor
tables, and two gloo ranks on one card render a tile each of one sample.
The packet walk of the traversal tools (every variant, both packet sizes)
matches its plain version's counts, t and ids, on random rays and on rays
at its edges (entries of ±0.0 and +inf, one active warp a group, a deep
stack), and the link probe's
kernel is a * 2 + 1 bit for bit, on its tails and on unaligned arrays.
Rows 8 and 9 replay from a CUDA graph, a launch under a side stream lands
on it, and the launch path's raw stream and device reads are pinned to
PyTorch's public ones.  The layout probes' kernels match their
plain versions at the script's shapes, the slab copy also at the edges of
its bands, the products also across several
tiles and from the smallest K to the largest on normals, mixed magnitudes
and cancelling sums, and raise off their tiles and past MAX_K:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py -k mosaic

The connection's two kernels match their plain versions on one sample of
Cornell and teapots at 64x48 under both estimators, both connection cast
rules and max_bounces 6 and 3, at any lane count; each launches once a
``connect_paths``, which then calls no plain version and reads no device
value on the host:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py -k connect

The RNG's two kernels (csrc/rng.cu) give the plain versions' bits
exactly: every draw (``uniform``, ``random_bits``) of either shape at any
length, on its own rows or on a permutation, a tile's slice or rows whose
counters pass 2^32, under keys from ``key``, ``fold_in``, ``split`` and
``wrap_key_data``, and every ``fold_in`` and ``split``; a sample on the
card launches one kernel a hash, 19 in all, and reads no device value on
the host in the RNG:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py -k rng

The trace's shading kernel (csrc/shade.cu) gives ``shade_plain``'s bits on
every output of every lane (a NaN equal to any NaN): each bounce of one
1080p sample of Cornell, the sponza stand-in and the glass dragon in
raster and Morton order, and a table made to reach every branch (material
types, indices outside the table, missed rays, cos_f == 0) under both
estimators, a scalar or per-lane from_camera, with and without a tile's
rows; a sample launches it once a bounce and never its plain version:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py -k shade
"""

import numpy as np
import pytest
import torch

import clive2_tpu_torch as ct
from clive2_tpu_torch import constants, rng
from clive2_tpu_torch.bvh.build import build_bvh, leaf_tables
from clive2_tpu_torch.geometry import TriangleSoup
from clive2_tpu_torch.integrator import render
from clive2_tpu_torch.models import icosphere
from clive2_tpu_torch.ops import brute, intersect, traverse_bvh2
from clive2_tpu_torch.ops import traverse_stream, traverse_stream2
from clive2_tpu_torch.ops import traverse_wide
from clive2_tpu_torch.testing import brute_edge_cases, tie_soup

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rays(gen, n, dev, spread=8.0):
    o = (torch.rand(n, 3, generator=gen, device=dev) * 2 - 1) * spread
    d = torch.randn(n, 3, generator=gen, device=dev)
    active = torch.rand(n, generator=gen, device=dev) < 0.7
    t_max = torch.rand(n, generator=gen, device=dev) * 12
    return o, d / d.norm(dim=1, keepdim=True), active, t_max


def _assert_same(got, want, closest=True):
    if not closest:
        assert torch.equal(got[0] >= 0, want[0] >= 0)
        return
    assert torch.equal(got[0], want[0])
    hit = want[0] >= 0
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a[hit], b[hit], rtol=1e-6, atol=1e-6)
    assert not torch.isfinite(got[1][~hit]).any()


def _soup(seed, t):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (t, 1, 3))
    return TriangleSoup.from_vertices(
        (c + rng.uniform(-0.4, 0.4, (t, 3, 3))).astype(np.float32))


@pytest.mark.parametrize("table", ["bvh2", "wide", "stream", "stream2"])
def test_a_tie_an_ulp_past_its_box_goes_to_the_lower_slot(dev, tmp_path,
                                                          table):
    """testing.ULP_TIE_RAY: a tie on a shared edge whose lower-slot leaf box
    enters an ulp past the hit.  Each traversal kernel answers as its plain
    version does, whether the ray fills a warp alone or is cast among
    random rays: the lower slot, but for the fat-leaf walk, whose own
    arithmetic breaks the tie by t."""
    from clive2_tpu_torch import scene as scene_mod
    from clive2_tpu_torch.testing import ULP_TIE_RAY, teapots_scene

    scene = teapots_scene(tmp_path, 512, 512, dev)
    rows = {k: v.cpu().numpy() for k, v in scene.data["bvh"].items()}
    data = dict(scene.data, **scene_mod.to_device(scene_mod.traversal_tables(
        rows, 0, cuda=True, traversal=table), dev))
    bits = lambda x: torch.tensor(x, dtype=torch.int32).view(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(9)
    o, d, _, _ = _rays(gen, 1 << 16, dev)
    o[::97] = bits(ULP_TIE_RAY["o"]).to(dev)
    d[::97] = bits(ULP_TIE_RAY["d"]).to(dev)
    t_max = torch.full((1 << 16,), float("inf"), device=dev)
    t_max[::97] = bits([ULP_TIE_RAY["t_max"]]).to(dev)
    wrapper, plain = {
        "bvh2": (traverse_bvh2.intersect_bvh2,
                 lambda *a, **k: intersect.intersect_bvh_packed(
                     *a[:2], scene.data["bvh"], **k)),
        "wide": (traverse_wide.intersect_wide,
                 lambda *a, **k: traverse_wide.wide_plain(
                     *a[:2], data["wide"], **k)),
        "stream": (traverse_stream.intersect_stream,
                   lambda *a, **k: traverse_stream.stream_plain(
                       *a[:2], data["stream"], **k)),
        "stream2": (traverse_stream2.intersect_stream2,
                    lambda *a, **k: traverse_stream2.stream2_plain(
                        *a[:2], data["stream2"], **k))}[table]
    want = plain(o, d, t_max=t_max)
    if table != "stream2":
        assert (want[0][::97] == ULP_TIE_RAY["want"]).all()
    alone = wrapper(o[:32].clone().copy_(o[0]), d[:32].clone().copy_(d[0]),
                    data, t_max=t_max[:32].clone().fill_(t_max[0]))
    assert (alone[0] == want[0][0]).all()
    _assert_same(wrapper(o, d, data, t_max=t_max), want)


@pytest.mark.parametrize("masked", [False, True])
def test_brute_kernel_matches_plain(dev, masked):
    gen = torch.Generator(device=dev).manual_seed(1)
    tris = torch.from_numpy(brute.pack_brute(_soup(1, 200))).to(dev)
    o, d, active, t_max = _rays(gen, 50_000, dev)
    kw = dict(active=active, t_max=t_max) if masked else {}
    before = brute.intersect_brute.launches
    got = brute.intersect_brute(o, d, tris, **kw)
    assert brute.intersect_brute.launches == before + 1
    _assert_same(got, brute.brute_plain(o, d, tris, **kw))


def test_brute_kernel_matches_plain_on_the_edge_cases(dev):
    """Rays at the edges of the exact test (clive2_tpu_torch.testing:
    brute_edge_cases): u underflowing to -0.0, a = +-0, u and v exactly 0
    or 1, u + v = 1, t at kDelta, each ray against both edge triangles; and
    rays inside the Cornell box, nearly all of which hit."""
    o, d, tris = (torch.from_numpy(x).to(dev) for x in brute_edge_cases())
    for k in range(tris.shape[0]):
        one = tris[k:k + 1]
        got = brute.intersect_brute(o, d, one)
        _assert_same(got, brute.brute_plain(o, d, one))
    cornell = ct.create_scene_from_preset("empty", 64, 36, device=dev)
    table = cornell.data["brute"]["tris"]
    gen = torch.Generator(device=dev).manual_seed(8)
    lo, hi = table[:, 0:3].min(0).values, table[:, 0:3].max(0).values
    o = lo + (hi - lo) * torch.rand(200_000, 3, generator=gen, device=dev)
    d = torch.randn(200_000, 3, generator=gen, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    got = brute.intersect_brute(o, d, table)
    _assert_same(got, brute.brute_plain(o, d, table))
    assert (got[0] >= 0).float().mean() > 0.9


def _bvh2_scene(dev, rows):
    return dict(
        bvh={k: torch.from_numpy(v).to(dev) for k, v in rows.items()},
        bvh2={k: torch.from_numpy(v).to(dev) for k, v in
              traverse_bvh2.pack_bvh2(rows["node_packed"],
                                      rows["leaf_packed"]).items()})


BVH2_CASES = ["closest", "capped", "any_hit", "ties", "odd_count",
              "all_inactive", "empty"]


@pytest.mark.parametrize("case", BVH2_CASES)
def test_bvh2_kernel_matches_gather_walk(dev, case):
    """The kernel equals the gather walk on every ray (any-hit: the
    verdicts); on the tie soup every hit is the id at the lower slot; a
    cast of no rays launches nothing, an all-inactive one writes
    misses."""
    gen = torch.Generator(device=dev).manual_seed(2)
    if case == "ties":
        rows, lower = tie_soup(2, 2000)
    else:
        soup = _soup(2, 3000)
        bvh = build_bvh(soup)
        rows = intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))
    scene = _bvh2_scene(dev, rows)
    n = {"odd_count": 50_001, "empty": 0}.get(case, 50_000)
    o, d, active, t_max = _rays(gen, n, dev)
    if case == "ties":
        aim = (torch.rand(n, 3, generator=gen, device=dev) * 10 - 5) - o
        d = aim / aim.norm(dim=1, keepdim=True)
        active, t_max = None, None
    elif case == "closest":
        t_max = None
    elif case == "all_inactive":
        active = torch.zeros_like(active)
    any_hit = case == "any_hit"
    before = traverse_bvh2.intersect_bvh2.launches
    got = traverse_bvh2.intersect_bvh2(o, d, scene, active=active,
                                       t_max=t_max, any_hit=any_hit)
    assert traverse_bvh2.intersect_bvh2.launches == before + (n > 0)
    want = intersect.intersect_bvh_packed(o, d, scene["bvh"], active=active,
                                          t_max=t_max)
    hits = int((got[0] >= 0).sum())
    if case == "all_inactive":
        assert hits == 0 and not torch.isfinite(got[1]).any()
    elif n:
        assert hits > 1000
    _assert_same(got, want, closest=not any_hit)
    if case == "ties":
        ids = got[0][got[0] >= 0].cpu().numpy()
        np.testing.assert_array_equal(ids, lower(ids))


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream2_kernel_matches_plain(dev, any_hit):
    gen = torch.Generator(device=dev).manual_seed(3)
    soup = _soup(3, 5000)
    bvh = build_bvh(soup)
    rows = intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))
    scene = dict(stream2={
        k: torch.from_numpy(v).to(dev) for k, v in
        traverse_stream2.pack_stream2(rows["node_packed"],
                                      rows["leaf_packed"]).items()})
    o, d, active, t_max = _rays(gen, 50_000, dev)
    before = traverse_stream2.intersect_stream2.launches
    got = traverse_stream2.intersect_stream2(o, d, scene, active=active,
                                             t_max=t_max, any_hit=any_hit)
    assert traverse_stream2.intersect_stream2.launches == before + 1
    want = traverse_stream2.stream2_plain(o, d, scene["stream2"],
                                          active=active, t_max=t_max,
                                          any_hit=any_hit)
    _assert_same(got, want)
    assert (got[0] >= 0).sum() > 1000


def _scene_tables(dev, seed, traversal, pack):
    soup = _soup(seed, 5000)
    bvh = build_bvh(soup)
    rows = intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))
    return dict(
        bvh={k: torch.from_numpy(v).to(dev) for k, v in rows.items()},
        **{traversal: {
            k: torch.from_numpy(v).to(dev) for k, v in
            pack(rows["node_packed"], rows["leaf_packed"]).items()}})


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["wide", "stream"])
def test_wide_and_stream_kernels_match_plain(dev, name, any_hit):
    module, wrapper, plain, pack = {
        "wide": (traverse_wide, "intersect_wide", "wide_plain",
                 traverse_wide.pack_bvh8),
        "stream": (traverse_stream, "intersect_stream", "stream_plain",
                   traverse_stream.pack_stream)}[name]
    gen = torch.Generator(device=dev).manual_seed(4)
    scene = _scene_tables(dev, 4, name, pack)
    o, d, active, t_max = _rays(gen, 50_000, dev)
    kernel = getattr(module, wrapper)
    before = kernel.launches
    got = kernel(o, d, scene, active=active, t_max=t_max, any_hit=any_hit)
    assert kernel.launches == before + 1
    want = getattr(module, plain)(o, d, scene[name], active=active,
                                  t_max=t_max, any_hit=any_hit)
    _assert_same(got, want)
    assert (got[0] >= 0).sum() > 1000
    if not any_hit:
        _assert_same(got, intersect.intersect_bvh_packed(
            o, d, scene["bvh"], active=active, t_max=t_max))


@pytest.mark.parametrize("case", ["ties", "odd_count", "all_inactive",
                                  "empty"])
def test_wide_kernel_matches_plain_on_ties_and_edges(dev, case):
    """The BVH8 kernel on the tie soup (every hit the id at the lower slot,
    as wide_plain and the gather walk), on a ray count that leaves a warp's
    fetch ragged, on an all-inactive cast (misses) and on no rays (no
    launch)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    if case == "ties":
        rows, lower = tie_soup(13, 3000)
    else:
        soup = _soup(13, 6000)
        bvh = build_bvh(soup)
        rows = intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))
    bvh_rows = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
    tables = {k: torch.from_numpy(v).to(dev) for k, v in
              traverse_wide.pack_bvh8(rows["node_packed"],
                                      rows["leaf_packed"]).items()}
    n = {"odd_count": 50_001, "empty": 0}.get(case, 50_000)
    o, d, active, t_max = _rays(gen, n, dev)
    if case == "ties":
        aim = (torch.rand(n, 3, generator=gen, device=dev) * 10 - 5) - o
        d = aim / aim.norm(dim=1, keepdim=True)
        active, t_max = None, None
    elif case == "all_inactive":
        active = torch.zeros_like(active)
    before = traverse_wide.intersect_wide.launches
    got = traverse_wide.intersect_wide(o, d, dict(wide=tables),
                                       active=active, t_max=t_max)
    assert traverse_wide.intersect_wide.launches == before + (n > 0)
    want = traverse_wide.wide_plain(o, d, tables, active=active, t_max=t_max)
    _assert_same(got, want)
    hits = int((got[0] >= 0).sum())
    if case in ("all_inactive", "empty"):
        assert hits == 0 and not torch.isfinite(got[1]).any()
        return
    assert hits > 1000
    _assert_same(got, intersect.intersect_bvh_packed(
        o, d, bvh_rows, active=active, t_max=t_max))
    if case == "ties":
        ids = got[0][got[0] >= 0].cpu().numpy()
        np.testing.assert_array_equal(ids, lower(ids))


@pytest.mark.parametrize("case", ["closest", "capped", "any_hit", "ties",
                                  "odd_count", "all_inactive"])
def test_stream_kernel_matches_plain(dev, case):
    """The streaming kernel equals stream_plain on every ray (any-hit: its
    ids too, since both stop at the same fat leaf) and the gather walk on
    closest and capped rays; on the tie soup every hit is the id at the
    lower slot; an all-inactive cast writes misses."""
    gen = torch.Generator(device=dev).manual_seed(12)
    if case == "ties":
        rows, lower = tie_soup(12, 3000)
    else:
        soup = _soup(12, 6000)
        bvh = build_bvh(soup)
        rows = intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))
    bvh_rows = {k: torch.from_numpy(v).to(dev) for k, v in rows.items()}
    tables = {k: torch.from_numpy(v).to(dev) for k, v in
              traverse_stream.pack_stream(rows["node_packed"],
                                          rows["leaf_packed"]).items()}
    n = 50_001 if case == "odd_count" else 50_000
    o, d, active, t_max = _rays(gen, n, dev)
    if case == "ties":
        aim = (torch.rand(n, 3, generator=gen, device=dev) * 10 - 5) - o
        d = aim / aim.norm(dim=1, keepdim=True)
        active, t_max = None, None
    elif case == "closest":
        t_max = None
    elif case == "all_inactive":
        active = torch.zeros_like(active)
    any_hit = case == "any_hit"
    before = traverse_stream.intersect_stream.launches
    got = traverse_stream.intersect_stream(o, d, dict(stream=tables),
                                           active=active, t_max=t_max,
                                           any_hit=any_hit)
    assert traverse_stream.intersect_stream.launches == before + 1
    want = traverse_stream.stream_plain(o, d, tables, active=active,
                                        t_max=t_max, any_hit=any_hit)
    _assert_same(got, want)
    hits = int((got[0] >= 0).sum())
    if case == "all_inactive":
        assert hits == 0 and not torch.isfinite(got[1]).any()
        return
    assert hits > 1000
    gather = intersect.intersect_bvh_packed(o, d, bvh_rows, active=active,
                                            t_max=t_max)
    _assert_same(got, gather, closest=not any_hit)
    if case == "ties":
        ids = got[0][got[0] >= 0].cpu().numpy()
        np.testing.assert_array_equal(ids, lower(ids))


@pytest.mark.parametrize("name", ["wide", "stream"])
def test_wide_and_stream_wrappers_raise(dev, name):
    """CUDA rays never fall back: a scene without the kernel's tables, or
    with its tables on the CPU, raises."""
    module, wrapper, pack = {
        "wide": (traverse_wide, "intersect_wide", traverse_wide.pack_bvh8),
        "stream": (traverse_stream, "intersect_stream",
                   traverse_stream.pack_stream)}[name]
    kernel = getattr(module, wrapper)
    scene = _scene_tables(dev, 5, name, pack)
    o, d, _, _ = _rays(torch.Generator(device=dev).manual_seed(5), 64, dev)
    with pytest.raises(ValueError, match=f"no {name} tables"):
        kernel(o, d, dict(bvh=scene["bvh"]))
    on_cpu = {k: v.cpu() for k, v in scene[name].items()}
    with pytest.raises(ValueError, match="is on cpu"):
        kernel(o, d, dict(scene, **{name: on_cpu}))


def test_render_on_the_card_matches_the_cpu(dev):
    imgs = {}
    for device in ("cpu", "cuda"):
        r = ct.Renderer(ct.create_scene_from_preset("empty", 32, 32,
                                                    device=device), seed=3)
        r.run_sample()
        imgs[device] = r.state["summed_image"].cpu().numpy()
    close = np.isclose(imgs["cuda"], imgs["cpu"], rtol=1e-3, atol=1e-6)
    assert close.all(-1).mean() >= 0.99
    assert abs(imgs["cuda"].mean() / imgs["cpu"].mean() - 1) < 1e-3


def _stream2_case(dev, seed, n=50_000):
    soup = _soup(seed, 5000)
    bvh = build_bvh(soup)
    rows = intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))
    tables = {k: torch.from_numpy(v).to(dev) for k, v in
              traverse_stream2.pack_stream2(rows["node_packed"],
                                            rows["leaf_packed"]).items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tables, _rays(gen, n, dev)


QUEUED = {"queued": (0, 1 << 22), "queued-tail": (2000, 7000)}
# case: (tail_min, chunk)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", list(QUEUED) + ["wrapper"])
def test_stream2_queued_matches_plain(dev, case, any_hit, monkeypatch):
    """The queued traversal (walk, bin, leaf test, tail) equals the plain
    walk on every ray, each of its kernels ran, and the wrapper takes it;
    a cast under QUEUE_MIN takes the per-thread kernel whole."""
    s2 = traverse_stream2
    monkeypatch.setattr(s2, "QUEUE_MIN", 50_000)
    tables, (o, d, active, t_max) = _stream2_case(dev, 6, n=100_000)
    scene = dict(stream2=tables)
    wrappers = (s2.walk_to_leaf, s2.count_by_leaf, s2.plan_tiles,
                s2.scatter_by_leaf, s2.leaf_test, s2.stream2_tail)
    before = [w.launches for w in wrappers]
    if case == "wrapper":
        got = s2.intersect_stream2(o, d, scene, active=active, t_max=t_max,
                                   any_hit=any_hit)
        assert s2.intersect_stream2.last["rounds"] > 0
        n = s2.QUEUE_MIN - 1
        threads = s2.stream2_thread.launches
        small = s2.intersect_stream2(o[:n], d[:n], scene, active=active[:n],
                                     t_max=t_max[:n], any_hit=any_hit)
        assert s2.stream2_thread.launches == threads + 1
        assert s2.intersect_stream2.last is None
        _assert_same(small, tuple(x[:n] for x in got))
        # an empty cast launches nothing and counts nothing
        casts = s2.intersect_stream2.launches
        s2.intersect_stream2(o[:0], d[:0], scene, any_hit=any_hit)
        assert s2.intersect_stream2.launches == casts
        assert s2.stream2_thread.launches == threads + 1
    else:
        tail_min, chunk = QUEUED[case]
        rays, tables, got = s2.kernel_args(o, d, scene, active, t_max)
        rounds, _ = s2.queued_cast(
            (rays.origin, rays.direction, rays.active, rays.t_max),
            s2.KernelSteps(tables, any_hit), got, chunk=chunk,
            tail_min=tail_min)
        assert rounds > 0
    assert all(w.launches > b for w, b in zip(wrappers, before))
    want = s2.stream2_plain(o, d, tables, active=active, t_max=t_max,
                            any_hit=any_hit)
    _assert_same(got, want)
    assert (got[0] >= 0).sum() > 1000


def _state_equal(a, b):
    for name in ("ray", "bt", "bc", "ref", "sp", "leaf"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    level = torch.arange(a.stack_t.shape[0], device=a.sp.device)[:, None]
    used = level < a.sp[None, :]
    assert torch.equal(a.stack_ref[used], b.stack_ref[used])
    assert torch.equal(a.stack_t[used], b.stack_t[used])


def _queue_sorted(st):
    """The queued rays, each fat leaf's in ascending order (the scatter
    kernel's order within a fat leaf is arbitrary)."""
    pos, f = traverse_stream2.queue_positions(st)
    return torch.sort(f * (st.n + 1) + st.queue[pos].long()).values


def test_stream2_parts_match_plain(dev):
    """One round of the queued traversal, kernel by kernel, against the
    plain steps on the same state."""
    s2 = traverse_stream2
    tables, (o, d, active, t_max) = _stream2_case(dev, 7)
    rays = (o, d, active, t_max)
    steps = s2.PlainSteps(tables, False)
    st_k, st_p = steps.state(o.shape[0]), steps.state(o.shape[0])
    s2.walk_to_leaf(st_k, tables, False, rays)
    s2.walk_to_leaf_plain(st_p, tables, False, rays)
    _state_equal(st_k, st_p)
    s2.bin_by_leaf(st_k)
    s2.bin_by_leaf_plain(st_p)
    for name in ("hist", "offs", "info"):
        assert torch.equal(getattr(st_k, name), getattr(st_p, name)), name
    assert torch.equal(st_k.cursor, st_p.offs + st_p.hist)
    assert torch.equal(_queue_sorted(st_k), _queue_sorted(st_p))

    st_p = st_k.clone()
    s2.leaf_test(st_k, tables)
    s2.leaf_test_plain(st_p, tables)
    assert torch.equal(st_k.bt, st_p.bt) and torch.equal(st_k.bc, st_p.bc)

    s2.walk_to_leaf(st_k, tables, False)
    s2.walk_to_leaf_plain(st_p, tables, False)
    _state_equal(st_k, st_p)
    out_k, out_p = ([torch.empty_like(x) for x in
                     (st_k.bc, st_k.bt, st_k.bt, st_k.bt)] for _ in range(2))
    s2.stream2_tail(st_k, tables, False, out_k)
    steps.tail(st_p, out_p)
    _assert_same(tuple(out_k), tuple(out_p))


def _recorded_casts(module, name, run):
    """``run()`` with the kernel wrapper ``module.<name>`` keeping the
    inputs of every cast it is given; returns them in call order."""
    fn = getattr(module, name)
    casts = []

    def record(origin, direction, tables, active=None, t_max=None, **kw):
        casts.append(dict(origin=origin.clone(), direction=direction.clone(),
                          active=active.clone(), t_max=t_max,
                          any_hit=kw.get("any_hit", False)))
        return fn(origin, direction, tables, active=active, t_max=t_max,
                  **kw)

    # the wrapper counts its launches on the name it has in its module
    record.launches = fn.launches
    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, fn)
        fn.launches = record.launches
    return casts


@pytest.mark.parametrize("kernel", ["brute", "bvh2"])
def test_reference_estimator_connection_cast(dev, kernel, monkeypatch):
    """Under CLIVE2_REFERENCE_MIS the connection cast is closest-hit, capped
    just beyond each target: the kernel equals its plain version on every
    ray of one sample's cast (Cornell 64x36 on brute; the Cornell room with
    a 1,280-triangle icosphere on BVH2)."""
    monkeypatch.setattr(constants, "REFERENCE_MIS", True)
    if kernel == "brute":
        scene = ct.create_scene_from_preset("empty", 64, 36, device=dev)
        module, name = brute, "intersect_brute"
    else:
        v, f = icosphere(3)
        scene = ct.create_scene(
            pixel_width=64, pixel_height=36, device=dev,
            cam_center=np.array([0, 1.5, 6]),
            cam_direction=np.array([0, 0, -1.0]),
            extra_geometry=TriangleSoup.from_vertices(
                (v[f] * 1.5 + np.array([0.0, 1.0, 0.0])).astype(np.float32),
                material=4))
        module, name = traverse_bvh2, "intersect_bvh2"
    n = 64 * 36
    casts = _recorded_casts(module, name, lambda: render.render_sample(
        rng.key(3, dev), scene.data, 64, 36))
    conn = [c for c in casts if c["origin"].shape[0] == 36 * n]
    assert len(casts) == 7 and len(conn) == 1
    c = conn[0]
    assert not c["any_hit"]
    assert torch.isfinite(c["t_max"][c["active"]]).float().mean() > 0.99
    args = (c["origin"], c["direction"])
    kw = dict(active=c["active"], t_max=c["t_max"])
    if kernel == "brute":
        tris = scene.data["brute"]["tris"]
        got = brute.intersect_brute(*args, tris, **kw)
        want = brute.brute_plain(*args, tris, **kw)
    else:
        got = traverse_bvh2.intersect_bvh2(*args, scene.data, **kw)
        want = intersect.intersect_bvh_packed(*args, scene.data["bvh"], **kw)
    _assert_same(got, want)
    # the targets register: most active rays hit under their caps
    assert (got[0][c["active"]] >= 0).float().mean() > 0.5


def test_subset_brute_casts(dev):
    """An adaptive subset's casts (1,001 pixels: a ragged last warp) on the
    brute kernel equal its plain version on every ray."""
    scene = ct.create_scene_from_preset("empty", 64, 36, device=dev)
    sel = torch.randperm(64 * 36, generator=torch.Generator().manual_seed(4))
    sel = sel[:1001].to(dev, torch.int32)
    casts = _recorded_casts(brute, "intersect_brute", lambda: (
        render.render_sample_subset(rng.key(5, dev), scene.data, sel, 64,
                                    36)))
    assert sorted({c["origin"].shape[0] for c in casts}) == [2002, 36036]
    tris = scene.data["brute"]["tris"]
    for c in casts:
        kw = dict(active=c["active"], t_max=c["t_max"])
        _assert_same(brute.intersect_brute(c["origin"], c["direction"], tris,
                                           **kw),
                     brute.brute_plain(c["origin"], c["direction"], tris,
                                       **kw))


def test_with_camera_brute_casts(dev):
    """A Cornell frame moved by with_camera (its brute table's sensor rows
    swapped): every cast of one sample on the kernel equals brute_plain on
    the moved table."""
    base = ct.create_scene_from_preset("empty", 64, 36, device=dev)
    scene = base.with_camera(ct.orbit_camera(3, 16, 64, 36))
    tris = scene.data["brute"]["tris"]
    assert not torch.equal(tris, base.data["brute"]["tris"])
    casts = _recorded_casts(brute, "intersect_brute", lambda: (
        render.render_sample(rng.key(6, dev), scene.data, 64, 36)))
    assert len(casts) == 7
    for c in casts:
        kw = dict(active=c["active"], t_max=c["t_max"])
        _assert_same(brute.intersect_brute(c["origin"], c["direction"], tris,
                                           **kw),
                     brute.brute_plain(c["origin"], c["direction"], tris,
                                       **kw))


def test_orbit_frame_bvh2_casts(dev):
    """A teapots orbit frame (frame 1 of 120 through with_camera): its BVH2
    casts equal the plain gather walk on every ray."""
    import os

    from clive2_tpu_torch.load import write_obj
    from clive2_tpu_torch.models import utah_teapot
    from clive2_tpu_torch.scene import RESOURCE_DIR

    teapot = os.path.join(RESOURCE_DIR, "teapot.obj")
    if not os.path.exists(teapot):
        os.makedirs(RESOURCE_DIR, exist_ok=True)
        v, f = utah_teapot(n=10)
        write_obj(teapot, v, f)
    base = ct.create_scene_from_preset_with_params("teapots", 64, 36, 0, 120,
                                                   device=dev)
    scene = base.with_camera(ct.orbit_camera(1, 120, 64, 36))
    assert scene.data["bvh2"] is base.data["bvh2"]
    casts = _recorded_casts(traverse_bvh2, "intersect_bvh2", lambda: (
        render.render_sample(rng.key(7, dev), scene.data, 64, 36)))
    assert len(casts) == 7
    for c in casts:
        kw = dict(active=c["active"], t_max=c["t_max"])
        got = traverse_bvh2.intersect_bvh2(c["origin"], c["direction"],
                                           scene.data, any_hit=c["any_hit"],
                                           **kw)
        want = intersect.intersect_bvh_packed(c["origin"], c["direction"],
                                              scene.data["bvh"], **kw)
        _assert_same(got, want, closest=not c["any_hit"])


def test_two_gloo_ranks_on_one_card(dev, tmp_path):
    """Renderer(mesh=) over two gloo ranks on cuda:0 against one device,
    one sample of Cornell 64x36: the ranks hold the same state, and it
    equals the single-device sample up to the order of float sums (the
    splat scatter's atomic adds and the all-reduce); each rank launched
    the brute kernel 7 times, as one device does, and no plain version."""
    from clive2_tpu_torch.testing import (check_launches, mesh_render,
                                          spawn_ranks)

    jobs = [("cornell", "empty", 64, 36, 3, 1)]
    spawn_ranks(mesh_render, 2, str(tmp_path), args=("cuda:0", jobs),
                timeout=300)
    a, b = (np.load(tmp_path / f"cornell-rank{r}.npz") for r in range(2))
    r = ct.Renderer(ct.create_scene_from_preset("empty", 64, 36, device=dev),
                    seed=3)
    r.run_sample()
    for k, v in r.state.items():
        np.testing.assert_array_equal(a[k], b[k], k)
        np.testing.assert_allclose(a[k], v.cpu().numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for rank in (a, b):
        check_launches("a gloo rank", ("brute",),
                       {k[9:]: int(rank[k]) for k in rank.files
                        if k.startswith("launches/")})
    assert a["launches/brute"] == b["launches/brute"] == 7


@pytest.mark.parametrize("rays", ["random", "faces", "far", "one_warp",
                                  "deep"])
@pytest.mark.parametrize("packet,group", [(1024, 128), (32, 32)])
@pytest.mark.parametrize("variant", ["full", "noleaf", "nogroupskip",
                                     "noorder", "noreduce"])
def test_packet_walk_matches_plain(dev, variant, packet, group, rays):
    """The packet walk kernel (csrc/packet_walk.cu) against its plain
    version on a 900-triangle soup: counts on every packet, t and ids on
    every ray, including a partial last packet and an empty cast.  Besides
    random rays, the rays at the kernel's edges (``testing.
    packet_edge_rays``): origins on box faces along the axes (entries of
    +0.0 and -0.0), rays far off the scene under t_max = inf (entries of
    +inf, zero directions hitting every box), one active warp a 128-ray
    group (the warp-level skip); and ``deep``: random rays on
    ``testing.deep_bvh2_tables``, whose walk holds 47 stack entries."""
    from clive2_tpu_torch.ops import packet_walk
    from clive2_tpu_torch.testing import deep_bvh2_tables, packet_edge_rays

    if rays == "deep":
        tables = {k: torch.from_numpy(v).to(dev)
                  for k, v in deep_bvh2_tables(48, 31).items()}
    else:
        soup = _soup(21, 900)
        bvh = build_bvh(soup)
        rows = intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))
        tables = {k: torch.from_numpy(v).to(dev) for k, v in
                  traverse_bvh2.pack_bvh2(rows["node_packed"],
                                          rows["leaf_packed"]).items()}
    gen = torch.Generator(device=dev).manual_seed(22)
    if rays in ("random", "deep"):
        o, d, active, t_max = _rays(gen, 5000, dev)
    else:
        o, d, active, t_max = (torch.from_numpy(x).to(dev) for x in
                               packet_edge_rays(tables["nodes"].cpu().numpy(),
                                                rays, 5000, 23))
    kw = dict(packet=packet, group=group, variant=variant, count=True)
    got = packet_walk.packet_walk(o, d, tables, active, t_max, **kw)
    torch.cuda.synchronize()
    want = packet_walk.packet_walk_plain(o, d, tables, active, t_max, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if rays == "deep":                 # every packet with an active ray
        lit = torch.zeros(got[2].shape[0] * packet, dtype=torch.bool,
                          device=dev)
        lit[:len(active)] = active
        lit = lit.view(-1, packet).any(1)
        assert lit.any() and (got[2][lit, 0] == 2 * 48 - 1).all()
    empty = packet_walk.packet_walk(o[:0], d[:0], tables, **kw)
    assert [x.numel() for x in empty] == [0, 0, 0]


def test_link_probe_kernel_is_two_a_plus_one(dev):
    from clive2_tpu_torch.ops.link_probe import scale_shift
    from clive2_tpu_torch.scripts import link_probe

    gen = torch.Generator(device=dev).manual_seed(23)
    for shape in (link_probe.SHAPE, (1000,), (0,)):
        a = torch.randn(shape, generator=gen, device=dev) * 1e3
        got = scale_shift(a)
        torch.cuda.synchronize()
        assert torch.equal(got, a * 2.0 + 1.0)


@pytest.mark.parametrize("n, offset", [(1, 0), (3, 0), (5, 0), (32768, 0),
                                       (32771, 0), (1001, 1), (4096, 3)])
def test_link_probe_kernel_tails_and_unaligned_arrays(dev, n, offset):
    """Every element past the last whole float4, and arrays that start off
    a 16-byte boundary (all scalar), equal a * 2 + 1 bit for bit."""
    from clive2_tpu_torch.ops.link_probe import scale_shift

    gen = torch.Generator(device=dev).manual_seed(n)
    a = (torch.randn(n + offset, generator=gen, device=dev) * 1e3)[offset:]
    got = scale_shift(a)
    torch.cuda.synchronize()
    assert torch.equal(got, a * 2.0 + 1.0)


def _probe_calls(dev):
    """(name, wrapper call, plain call) of the link probe at its shape and
    of each slab copy at the script's shapes."""
    from clive2_tpu_torch.ops import link_probe as lp
    from clive2_tpu_torch.ops import mosaic_probes as mp
    from clive2_tpu_torch.scripts import probe_mosaic_layouts as tool

    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn(256, 128, generator=gen, device=dev) * 1e3
    calls = [("link_probe", lambda: lp.scale_shift(a),
              lambda: lp.scale_shift_plain(a))]
    for tag, kernel, shapes in tool.PROBES:
        if kernel == "slab_copy":
            x, = tool.inputs(shapes, dev)
            calls.append((tag, lambda x=x: mp.slab_copy(x),
                          lambda x=x: mp.slab_copy_plain(x)))
    return calls


def test_probe_kernels_replay_from_a_cuda_graph(dev):
    """Rows 8 and 9 captured into one CUDA graph, three calls each, and
    replayed twice: every output equal to the plain version bit for bit
    (a launch onto another stream than the capture's fails the capture)."""
    calls = _probe_calls(dev)
    for _, fn, _ in calls:
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [[fn() for _ in range(3)] for _, fn, _ in calls]
    for _ in range(2):
        g.replay()
        torch.cuda.synchronize()
        for (name, _, plain), got in zip(calls, outs):
            want = plain()
            assert all(torch.equal(o, want) for o in got), name


def test_a_launch_under_a_side_stream_lands_on_it(dev):
    """Under ``torch.cuda.stream(side)`` the probe kernel runs on ``side``:
    held behind a long sleep there, its output is not written when the
    default stream has drained, and is once ``side`` has."""
    from clive2_tpu_torch import kernels

    a = torch.randn(4096, device=dev)
    o = torch.zeros_like(a)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1 << 30)                 # about half a second
        kernels.call("clive2_link_probe", dev, a.data_ptr(), o.data_ptr(),
                     a.numel())
    torch.cuda.default_stream().synchronize()
    assert not side.query()
    assert torch.equal(o.cpu(), torch.zeros(4096))
    side.synchronize()
    assert torch.equal(o, a * 2.0 + 1.0)


def test_raw_stream_handle_is_the_current_streams(dev):
    """The private reads of the launch path (kernels.call):
    torch._C._cuda_getCurrentRawStream and torch._C._cuda_getDevice give
    what the public calls give, on the default stream and under a side
    stream: a PyTorch that changes either fails here."""
    index = torch.cuda.current_device()
    assert torch._C._cuda_getDevice() == index
    side = torch.cuda.Stream()
    for stream in (torch.cuda.current_stream(), side):
        with torch.cuda.stream(stream):
            raw = torch._C._cuda_getCurrentRawStream(index)
            assert type(raw) is int
            assert (raw == torch.cuda.current_stream().cuda_stream
                    == stream.cuda_stream)
    assert side.cuda_stream != torch.cuda.default_stream().cuda_stream


# slabs at the bands' edges (ops/mosaic_probes.py:bands): whole bands, a
# shorter last band, one band, rows under the window, the largest slab,
# single-row bands' neighbours: (rows, cols)
BAND_EDGE_SLABS = [(300, 64), (113, 200), (9, 1000), (33, 2040), (453, 256),
                   (640, 4), (100, 8), (7, 16), (5, 24), (1, 8), (128, 64),
                   (129, 64)]


@pytest.mark.parametrize("rows, cols", BAND_EDGE_SLABS)
def test_slab_copy_at_band_edges(dev, rows, cols):
    """The banded slab copy equals its plain version bit for bit, one launch
    a call, however the slab's rows split into bands."""
    from clive2_tpu_torch.ops import mosaic_probes as mp

    rng = np.random.default_rng(rows * cols)
    x = torch.from_numpy(rng.standard_normal((3, rows, cols)).astype(
        np.float32)).to(torch.bfloat16).to(dev)
    launches = mp.slab_copy.launches
    got = mp.slab_copy(x)
    torch.cuda.synchronize()
    assert mp.slab_copy.launches == launches + 1
    assert torch.equal(got, mp.slab_copy_plain(x))


@pytest.mark.parametrize("tag", ["dma64", "dma128", "dmaT", "dotT",
                                 "dot128"])
def test_mosaic_probe_kernel_matches_plain(dev, tag):
    """Each layout probe's kernel at the script's shapes: the copies equal
    their plain version bit for bit, the products within 2^-14 |A|ᵀ|B|
    (scripts/probe_mosaic_layouts.py in this package: ``held``)."""
    from clive2_tpu_torch.ops import mosaic_probes as mp
    from clive2_tpu_torch.scripts import probe_mosaic_layouts as tool

    _, kernel, shapes = next(p for p in tool.PROBES if p[0] == tag)
    args = tool.inputs(shapes, dev)
    wrapper = getattr(mp, kernel)
    launches = wrapper.launches
    got, _ = tool.held(kernel, args)
    assert wrapper.launches == launches + 1
    assert got.is_cuda and got.dtype == torch.float32


# products across several M and N tiles, at the smallest K, at a K that
# ends inside a TMA box (48, 208) and at the largest (MAX_K), beside the
# script's shapes: (M, N, K), N a multiple of every tile width tried
PRODUCT_SHAPES = [(640, 128, 128), (640, 128, 64), (192, 256, 16),
                  (128, 384, 48), (64, 128, 208), (256, 256, 512)]


def _product_operands(kind, m, n, k):
    """f64 A [M, K] and B [K, N]: normals; normals times powers of two
    from 2^-24 to 2^24 elementwise ("large"); or a second half of K that
    undoes the first up to a 2^-8 change in A ("cancelling")."""
    rng = np.random.default_rng(m * n + k)
    a, b = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    if kind == "large":
        a *= 2.0 ** rng.integers(-24, 25, size=a.shape)
        b *= 2.0 ** rng.integers(-24, 25, size=b.shape)
    elif kind == "cancelling":
        h = k // 2
        a[:, h:2 * h] = a[:, :h] * (1 + 2.0 ** -8
                                    * rng.standard_normal((m, h)))
        b[h:2 * h] = -b[:h]
    return a, b


@pytest.mark.parametrize("kind", ["normal", "large", "cancelling"])
@pytest.mark.parametrize("shape", PRODUCT_SHAPES)
@pytest.mark.parametrize("kernel", ["matmul", "matmul_t"])
def test_mosaic_products_within_rel_of_plain(dev, kernel, shape, kind):
    """Each product kernel within ``REL`` |A|ᵀ|B| of its plain version on
    every element, one launch a call."""
    from clive2_tpu_torch.ops import mosaic_probes as mp

    m, n, k = shape
    a, b = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
            for x in _product_operands(kind, m, n, k))
    transposed = kernel == "matmul_t"
    a = (a.t().contiguous() if transposed else a).to(dev)
    b = b.to(dev)
    wrapper = getattr(mp, kernel)
    launches = wrapper.launches
    got = wrapper(a, b)
    torch.cuda.synchronize()
    assert wrapper.launches == launches + 1
    assert got.shape == (m, n) and got.dtype == torch.float32
    want = getattr(mp, f"{kernel}_plain")(a, b)
    bound = mp.REL * mp.abs_product(a, b, transposed)
    excess = (got - want).abs() - bound
    i, j = divmod(int(excess.argmax()), n)
    assert bool((excess <= 0).all()), (
        f"worst element [{i}, {j}]: kernel {got[i, j].item()!r}, plain "
        f"{want[i, j].item()!r}, bound {bound[i, j].item()!r}")


def test_mosaic_products_raise_past_max_k(dev):
    """K past MAX_K (all of K resident in shared memory) raises, in the
    wrapper and in the C entry."""
    import ctypes

    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.ops import mosaic_probes as mp

    k = mp.MAX_K + mp.TILE["k"]
    a = torch.ones(64, k, dtype=torch.bfloat16, device=dev)
    b = torch.ones(k, 128, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="up to"):
        mp.matmul(a, b)
    with pytest.raises(ValueError, match="up to"):
        mp.matmul_t(a.t().contiguous(), b)
    out = torch.empty(64, 128, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.call("clive2_mma_bf16", dev, kernels.ptr(a), kernels.ptr(b),
                     kernels.ptr(out), ctypes.c_int(64), ctypes.c_int(128),
                     ctypes.c_int(k), ctypes.c_int(0))


# shapes off the kernels' tiles: a slab of 30 bytes, K = 40, M = 600
OFF_TILE = {"slab_copy": [(4, 5, 3)], "matmul_t": [(40, 640), (40, 128)],
            "matmul": [(600, 128), (128, 128)]}


@pytest.mark.parametrize("kernel", list(OFF_TILE))
def test_mosaic_probe_kernels_raise_off_their_tiles(dev, kernel):
    """The wrapper raises, and does not fall back, on a shape its kernel
    does not take; so does the C entry when called past the wrapper."""
    import ctypes

    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.ops import mosaic_probes as mp

    args = [torch.zeros(s, dtype=torch.bfloat16, device=dev)
            for s in OFF_TILE[kernel]]
    with pytest.raises(ValueError):
        getattr(mp, kernel)(*args)
    out = torch.empty(640, 128, device=dev)
    ptr = kernels.ptr
    if kernel == "slab_copy":
        entry = ("clive2_slab_copy", ptr(args[0]), ctypes.c_int(5),
                 ctypes.c_int(3), ctypes.c_int(5), ptr(out))
    else:
        entry = ("clive2_mma_bf16", ptr(args[0]), ptr(args[1]), ptr(out),
                 ctypes.c_int(600), ctypes.c_int(128), ctypes.c_int(40),
                 ctypes.c_int(int(kernel == "matmul_t")))
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.call(entry[0], dev, *entry[1:])


# ---- the connection's two kernels (csrc/connect.cu) -------------------------

CONNECT_W, CONNECT_H = 64, 48


@pytest.fixture(scope="module")
def connect_scenes(tmp_path_factory):
    """Cornell (diffuse, brute kernel) and teapots (glass: specular
    vertices; BVH2 kernel) at 64x48 on the card, built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from clive2_tpu_torch.testing import teapots_scene

    dev = torch.device("cuda")
    return dict(
        cornell=ct.create_scene_from_preset("empty", CONNECT_W, CONNECT_H,
                                            device=dev),
        teapots=teapots_scene(tmp_path_factory.mktemp("teapots"), CONNECT_W,
                              CONNECT_H, dev))


def _subpaths(scene, max_bounces, seed=5):
    """One raster sample's camera and light subpaths, as ``connect_paths``
    receives them (views of the merged trace: each field's depth rows
    2N lanes apart)."""
    w = render.trace_wavefront(rng.key(seed, "cuda"), scene.data, CONNECT_W,
                               CONNECT_H, max_bounces=max_bounces)
    return w["cam_path"], w["light_path"]


def _near_threshold(cam_path, light_path, data, pairs):
    """[P, N] bool: rays whose deciding dot (t=1: the projection against
    the camera direction, against 0; a join: either junction cosine,
    against DELTA) lies within 1e-6 of its threshold, where the kernel's
    dot, summed in another order, may decide otherwise."""
    from clive2_tpu_torch.constants import DELTA
    from clive2_tpu_torch.ops.sampling import dot, normalize

    CV, LV = cam_path["vertices"], light_path["vertices"]
    t_i = torch.tensor([t - 1 for t, _ in pairs], device=CV["origin"].device)
    s_i = torch.tensor([s - 1 for _, s in pairs], device=CV["origin"].device)
    lv_o, lv_n = LV["origin"][s_i], LV["normal"][s_i]
    cv_o, cv_n = CV["origin"][t_i], CV["normal"][t_i]
    cam = data["camera"]
    proj = normalize(cam["focal_point"] - lv_o)
    d = normalize(cv_o - lv_o)
    near = lambda x, thr: (x - thr).abs() <= 1e-6
    return torch.where((t_i == 0)[:, None],
                       near(dot(proj, cam["direction"]), 0.0),
                       near(dot(lv_n, d), DELTA) | near(dot(cv_n, -d), DELTA))


@pytest.mark.parametrize("any_hit", [True, False])
@pytest.mark.parametrize("max_bounces", [6, 3])
@pytest.mark.parametrize("preset", ["cornell", "teapots"])
def test_connect_rays_kernel_matches_its_plain_version(
        dev, connect_scenes, monkeypatch, preset, max_bounces, any_hit):
    """Stage A: ``origin`` is a copy, so equal; ``active`` equal but where
    the deciding dot lies within 1e-6 of its threshold; ``direction`` (a
    unit vector: absolute is relative to its length) and ``t_max`` within
    1e-6 relative, since the kernel's 3-term dots may round in another
    order than PyTorch's reduce (both are built with --fmad=false)."""
    from clive2_tpu_torch.integrator import connect

    # the reference estimator casts closest-hit (any_hit False); its
    # subpaths store their vertices by its own rule
    monkeypatch.setattr(constants, "REFERENCE_MIS", not any_hit)
    scene = connect_scenes[preset]
    cam_path, light_path = _subpaths(scene, max_bounces)
    pairs = connect.connection_pairs(max_bounces)
    got = connect.rays_kernel(cam_path, light_path, scene.data, pairs,
                              any_hit)
    want = connect.connection_rays_plain(cam_path, light_path, scene.data,
                                         pairs, None, None, any_hit)
    assert torch.equal(got[0], want[0])
    near = _near_threshold(cam_path, light_path, scene.data, pairs)
    assert torch.equal(got[2] | near, want[2] | near)
    assert want[2].any() and (~want[2]).any()
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("any_hit_env", ["1", "0"])
@pytest.mark.parametrize("reference", [False, True])
@pytest.mark.parametrize("max_bounces", [6, 3])
@pytest.mark.parametrize("preset", ["cornell", "teapots"])
def test_connect_shade_kernel_matches_its_plain_version(
        dev, connect_scenes, monkeypatch, preset, max_bounces, reference,
        any_hit_env):
    """Stage B on one cast: ``contribution`` and ``contrib_weight_sum``
    within 1e-5 relative (the same arithmetic in the same order, but for
    dots that may sum in another order); the light images within 1e-4
    relative plus 1e-6 absolute, because the order of the atomics, like
    that of ``index_add_``, varies from run to run."""
    from clive2_tpu_torch.integrator import connect

    monkeypatch.setattr(constants, "REFERENCE_MIS", reference)
    monkeypatch.setenv("CLIVE2_ANY_HIT", any_hit_env)
    any_hit = not reference and connect.any_hit_casts()
    scene = connect_scenes[preset]
    cam_path, light_path = _subpaths(scene, max_bounces)
    pairs = connect.connection_pairs(max_bounces)
    o, d, active, t_max = connect.connection_rays_plain(
        cam_path, light_path, scene.data, pairs, None, None, any_hit)
    tri, t = connect.cast_connections(o, d, active, t_max, scene.data,
                                      any_hit, None)
    args = (cam_path, light_path, scene.data, tri, t, active, CONNECT_W,
            CONNECT_H, max_bounces)
    got = connect.shade_kernel(*args)
    want = connect.shade_plain(*args)
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    for a, b in zip(got[2:], want[2:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    assert want[1].sum() > 0 and want[3].sum() > 0


@pytest.mark.parametrize("reference", [False, True])
def test_connect_paths_launches_each_kernel_once(dev, connect_scenes,
                                                 monkeypatch, reference):
    """Every ``connect_paths`` on the card launches each kernel once and
    calls neither plain version, with no host read of a device value in
    the wrappers (CUDA's sync debug mode raises on one); its ``n_rays``
    and outputs are those of ``debug_per_strategy=True``, which runs the
    plain versions and launches neither kernel."""
    from clive2_tpu_torch.integrator import connect
    from clive2_tpu_torch.testing import launch_counters

    monkeypatch.setattr(constants, "REFERENCE_MIS", reference)
    scene = connect_scenes["teapots"]
    cam_path, light_path = _subpaths(scene, 6, seed=8)
    names = ("connect_rays", "connect_shade", "connect_rays_plain",
             "connect_shade_plain")
    counters = launch_counters()

    def counts():
        return [getattr(*counters[k]) for k in names]

    before = counts()
    got = connect.connect_paths(cam_path, light_path, scene.data, CONNECT_W,
                                CONNECT_H)
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 0, 0]
    before = counts()
    want = connect.connect_paths(cam_path, light_path, scene.data,
                                 CONNECT_W, CONNECT_H,
                                 debug_per_strategy=True)
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, 1, 1]
    assert int(got["n_rays"]) == int(want["n_rays"]) > 0
    for k in ("contribution", "contrib_weight_sum"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=0)
    for k in ("light_image", "light_weight_image"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=1e-6)

    any_hit = not reference
    pairs = connect.connection_pairs(6)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        o, d, active, t_max = connect.rays_kernel(
            cam_path, light_path, scene.data, pairs, any_hit)
        tri = torch.full(active.shape, -1, dtype=torch.int32, device=dev)
        t = torch.full(active.shape, float("inf"), device=dev)
        connect.shade_kernel(cam_path, light_path, scene.data, tri, t,
                             active, CONNECT_W, CONNECT_H)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_connect_kernels_neither_spill_nor_keep_a_stack_frame(dev):
    """ptxas's report on csrc/connect.cu: every instance keeps its chains
    in registers (the unrolled strategies index no local array)."""
    from clive2_tpu_torch import kernels

    kernels.load()
    report = kernels.ptxas_report("connect.cu")
    parts = report.split("Compiling entry function")[1:]
    assert len(parts) == 4
    for part in parts:
        assert "0 bytes stack frame, 0 bytes spill stores" in part, part


def test_connect_kernels_take_any_lane_count_and_raise_past_max_bounces(
        dev, connect_scenes):
    """A wavefront of a few lanes (a tile's or a subset's), one lane, and
    none, as the plain versions give them; max_bounces past MAX_BOUNCES
    raises, and so does the C entry when called past the wrapper."""
    from clive2_tpu_torch import kernels
    from clive2_tpu_torch.integrator import connect

    scene = connect_scenes["cornell"]
    cam_path, light_path = _subpaths(scene, 6)
    pairs = connect.connection_pairs(6)
    cut = lambda p, n: dict(vertices={k: v[:, :n] for k, v in
                                      p["vertices"].items()},
                            length=p["length"][:n])
    for n in (1, 77):
        cam, light = cut(cam_path, n), cut(light_path, n)
        got = connect.rays_kernel(cam, light, scene.data, pairs, True)
        want = connect.connection_rays_plain(cam, light, scene.data, pairs,
                                             None, None, True)
        assert torch.equal(got[0], want[0]) and got[2].shape == (36, n)
        tri, t = connect.cast_connections(*want, scene.data, True, None)
        args = (cam, light, scene.data, tri, t, want[2], CONNECT_W,
                CONNECT_H)
        for a, b in zip(connect.shade_kernel(*args),
                        connect.shade_plain(*args)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    # no lanes: nothing to launch, outputs of no lanes and empty images
    cam, light = cut(cam_path, 0), cut(light_path, 0)
    launches = connect.rays_kernel.launches, connect.shade_kernel.launches
    o, _, active, _ = connect.rays_kernel(cam, light, scene.data, pairs,
                                          True)
    assert o.shape == (36, 0, 3) and active.shape == (36, 0)
    got = connect.shade_kernel(cam, light, scene.data,
                               torch.zeros((36, 0), dtype=torch.int32,
                                           device=dev),
                               torch.zeros((36, 0), device=dev), active,
                               CONNECT_W, CONNECT_H)
    assert got[0].shape == (0, 3) and not got[2].any()
    assert (connect.rays_kernel.launches,
            connect.shade_kernel.launches) == launches
    tri = torch.zeros((49, 4), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="max_bounces"):
        connect.shade_kernel(cam_path, light_path, scene.data, tri,
                             tri.float(), tri.bool(), CONNECT_W, CONNECT_H,
                             7)
    out = torch.empty(16, device=dev)
    p = out.data_ptr()
    with pytest.raises(RuntimeError, match="launch failed"):
        kernels.call("clive2_connect_shade", dev, *[p] * 10, 1, *[p] * 9, 1,
                     p, 1, 7, *[p] * 6, 8, p, 16, 1, *[p] * 7, 4, 4, 0,
                     *[p] * 4)


# ---- the RNG's two kernels (csrc/rng.cu) -------------------------------------

RNG_LENGTHS = [0, 1, 77, 4_147_200]


def _rng_keys(dev):
    """Keys of each kind on the card: ``key``, ``fold_in``, ``split`` (a
    row of the [3, 2] keys, a view at an offset) and ``wrap_key_data``."""
    k = rng.key(2**32 - 1, dev)
    return dict(key=rng.key(1234, dev), fold_in=rng.fold_in(k, 2**31 + 5),
                split=rng.split(k, 3)[2],
                wrap_key_data=rng.wrap_key_data([0xDEADBEEF, 7], dev))


def _rng_rows(kind, n, dev):
    gen = torch.Generator(device=dev).manual_seed(n)
    return dict(
        none=None,
        permutation=torch.randperm(n, generator=gen, device=dev),
        tile=torch.arange(3 * n + 11, 4 * n + 11, device=dev),
        past_2_32=torch.arange(n, device=dev) + (2**32 - n // 2))[kind]


@pytest.mark.parametrize("rows", ["none", "permutation", "tile",
                                  "past_2_32"])
@pytest.mark.parametrize("n", RNG_LENGTHS)
@pytest.mark.parametrize("inner", [(), (2,)])
def test_rng_draws_equal_their_plain_versions_bit_for_bit(dev, inner, n,
                                                          rows):
    """``uniform`` and ``random_bits`` on a key on the card (the kernel)
    against ``uniform_plain`` and ``random_bits_plain`` on the same key:
    equal as int32 words, not within a tolerance.  Rows past 2^32 make the
    counter's high word non-zero."""
    shape = (n,) + inner
    r = _rng_rows(rows, n, dev)
    for name, k in _rng_keys(dev).items():
        before = rng.uniform_kernel.launches
        got = rng.uniform(k, shape, rows=r)
        bits = rng.random_bits(k, shape, rows=r)
        assert rng.uniform_kernel.launches == before + 2 * (n > 0)
        want = rng.uniform_plain(k, shape, rows=r)
        want_bits = rng.random_bits_plain(k, shape, rows=r)
        assert got.dtype == torch.float32 and bits.dtype == torch.int64
        assert got.shape == want.shape == bits.shape, name
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
            name
        assert torch.equal(bits, want_bits), name
        assert n == 0 or (got.min() >= 0 and got.max() < 1)


def test_rng_keys_equal_their_plain_versions(dev):
    """``fold_in`` (data of 0 to 2^32 - 1, and negative data taken to 32
    bits) and ``split`` (1 to 1,000 keys) on the card against their plain
    versions, on every kind of key."""
    for name, k in _rng_keys(dev).items():
        for data in (0, 1, 5, 77, 2**31, 2**32 - 1, -1, 2**40 + 3):
            got = rng.fold_in(k, data)
            assert got.shape == (2,) and got.device == k.device
            assert torch.equal(got, rng.fold_in_plain(k, data)), (name, data)
        for num in (1, 2, 3, 7, 1000):
            got = rng.split(k, num)
            assert torch.equal(got, rng.split_plain(k, num)), (name, num)
    assert rng.split(rng.key(3, dev), 0).shape == (0, 2)


@pytest.mark.parametrize("preset", ["cornell", "teapots"])
def test_a_sample_launches_one_rng_kernel_a_hash(dev, connect_scenes,
                                                 monkeypatch, preset):
    """One ``Renderer.run_sample`` at 64x48 launches 19 RNG kernels (4
    draws, 15 key derivations: the shading kernel draws each bounce's
    uniforms itself) and calls no plain version of the RNG; each
    of the RNG's calls runs under CUDA's sync debug mode, which raises on a
    host read of a device value.  The sample equals the same sample drawn
    through the plain versions."""
    from clive2_tpu_torch.testing import (RNG_KERNELS, RNG_PLAIN,
                                          launch_counters)

    def no_sync(fn):
        def inner(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return inner

    scene = connect_scenes[preset]
    counters = launch_counters()
    names = RNG_KERNELS + RNG_PLAIN
    with monkeypatch.context() as m:
        for fn in ("fold_in", "split", "uniform", "random_bits"):
            m.setattr(rng, fn, no_sync(getattr(rng, fn)))
        r = ct.Renderer(scene, seed=2**31 + 9, device=dev)
        before = [getattr(*counters[k]) for k in names]
        r.run_sample()
        torch.cuda.synchronize()
        after = [getattr(*counters[k]) for k in names]
    assert [a - b for a, b in zip(after, before)] == [4, 15, 0, 0, 0]
    with monkeypatch.context() as m:
        m.setattr(rng, "fold_in", rng.fold_in_plain)
        m.setattr(rng, "split", rng.split_plain)
        m.setattr(rng, "uniform", rng.uniform_plain)
        plain = ct.Renderer(scene, seed=2**31 + 9, device=dev)
        plain.run_sample()
    # the light image's atomics add in an order that varies from run to run
    for k in ("summed_image", "summed_weight", "summed_unidirectional"):
        torch.testing.assert_close(r.state[k], plain.state[k], rtol=1e-4,
                                   atol=1e-6)


def test_rng_kernels_neither_spill_nor_keep_a_stack_frame(dev):
    """ptxas's report on csrc/rng.cu: the four draw instances (rows given
    or not; bits or uniform) and the key kernel keep every word in
    registers."""
    from clive2_tpu_torch import kernels

    kernels.load()
    report = kernels.ptxas_report("rng.cu")
    parts = report.split("Compiling entry function")[1:]
    assert len(parts) == 5
    for part in parts:
        assert "0 bytes stack frame, 0 bytes spill stores" in part, part


# ---- the trace's shading kernel (csrc/shade.cu) -------------------------------

def _same_bits(a, b):
    """Per lane: equal bit for bit (a NaN equal to any NaN), over a row's
    three components for vectors."""
    if a.dtype.is_floating_point:
        same = ((a.view(torch.int32) == b.view(torch.int32))
                | (torch.isnan(a) & torch.isnan(b)))
    else:
        same = a == b
    return same.all(-1) if same.dim() > 1 else same


def _shade_copy(a):
    """Shade's keyword arguments ``a`` with everything the shading writes
    copied."""
    return dict(a, cur={k: v.clone() for k, v in a["cur"].items()},
                active=a["active"].clone(),
                fwd_pending=a["fwd_pending"].clone(),
                vertices={k: v.clone() for k, v in a["vertices"].items()},
                stored=a["stored"].clone())


def _shade_both(a, kernel):
    """``kernel`` (the shading kernel's wrapper) and the plain version on
    copies of ``a``: {output: lanes that differ} over the next rays,
    active, the pending pdfs, vertex ``depth`` and its stored flag; the
    kernel's outputs; the kernel's copy of ``a``."""
    from clive2_tpu_torch.integrator import trace

    k, p = _shade_copy(a), _shade_copy(a)
    got = kernel(**k)
    want = trace.shade_plain(**p)
    d = a["depth"]
    pairs = ([(f"next {f}", got[0][f], want[0][f])
              for f in trace.RAY_FIELDS]
             + [("active", got[1], want[1]), ("pending", got[2], want[2]),
                ("stored", k["stored"][d], p["stored"][d])]
             + [(f"vertex {f}", k["vertices"][f][d], p["vertices"][f][d])
                for f in trace.RAY_FIELDS])
    diffs = {name: int((~_same_bits(x, y)).sum()) for name, x, y in pairs}
    return {name: v for name, v in diffs.items() if v}, got, k


def _preset_scene(preset, workdir, width, height):
    """``preset`` on the card, its meshes written into ``workdir`` by the
    port's generator (``scripts/make_assets.py``)."""
    import os

    from clive2_tpu_torch.scene import scene_presets
    from clive2_tpu_torch.scripts.make_assets import write_mesh

    p = scene_presets[preset]
    specs = []
    for spec in p.get("file_specs") or ():
        name = os.path.basename(spec["file_path"])
        write_mesh(str(workdir), name)
        specs.append(dict(spec, file_path=os.path.join(str(workdir), name)))
    return ct.create_scene(pixel_width=width, pixel_height=height,
                           cam_center=p["cam_center"],
                           cam_direction=p["cam_direction"],
                           file_specs=specs or None, device="cuda")


@pytest.fixture(scope="module")
def frames_1080p(tmp_path_factory):
    """The benchmark cells' scenes at 1920x1080 on the card: Cornell
    (brute kernel), the sponza stand-in (queued fat-leaf traversal) and the
    glass dragon (BVH2 kernel), built once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    work = tmp_path_factory.mktemp("meshes")
    return {name: _preset_scene(preset, work, 1920, 1080)
            for name, preset in (("cornell", "empty"), ("sponza", "sponza"),
                                 ("dragon", "dragon"))}


@pytest.mark.parametrize("order", ["raster", "morton"])
@pytest.mark.parametrize("name", ["cornell", "sponza", "dragon"])
def test_trace_shade_kernel_equals_plain_on_a_1080p_sample(
        dev, frames_1080p, monkeypatch, name, order):
    """Every bounce of one 1080p sample's merged trace (4,147,200 lanes):
    the kernel and ``shade_plain`` on the same inputs give the same bits
    on every output of every lane (NaN equal to NaN); the trace goes on
    from the kernel's outputs."""
    from clive2_tpu_torch.integrator import trace

    kernel = trace.shade_kernel
    seen = []

    def both(*args):
        a = dict(zip(("keys", "depth", "hit", "cur", "active", "fwd_pending",
                      "fc", "lanes", "scene", "vertices", "stored"), args))
        seen.append((a["depth"], _shade_both(a, kernel)[0]))
        return kernel(*args)

    # the wrapper counts its launches on the name trace_subpaths calls
    both.launches = 0
    monkeypatch.setattr(trace, "shade_kernel", both)
    scene = frames_1080p[name]
    w = render.trace_wavefront(rng.key(2**31 + 101, dev), scene.data, 1920,
                               1080, order=order)
    assert int(w["cam_path"]["valid"][0].sum()) > 0
    assert [d for d, _ in seen] == list(range(6))
    assert all(not diffs for _, diffs in seen), seen


SHADE_TRIS = 14


def _shade_case(dev, fc, rows, depth, n=4099, seed=3):
    """Shade's keyword arguments for ``n`` lanes at ``depth`` on a table
    made to reach every branch: material types 0, 1 (delta and rough), 2,
    3 and 7, material indices below and past the table and a fraction that
    truncates, zero vertex normals, emitter and sensor rows, an axis
    face on which some rays hit with cos_f == 0, missed rays and ids past
    the rows; inactive lanes; ``fc`` "camera", "light" or "per_lane";
    ``rows``: the lanes of a tile whose counters pass 2^32."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def unit(*shape):
        v = torch.randn(*shape, 3, generator=g, device=dev)
        return v / v.norm(dim=-1, keepdim=True)

    def uni(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    packed = torch.zeros((SHADE_TRIS, 16), device=dev)
    packed[:, 0:3] = unit(SHADE_TRIS)
    packed[:, 3:12] = unit(SHADE_TRIS, 3).reshape(SHADE_TRIS, 9)
    packed[0, 0:3] = torch.tensor([0.0, 1.0, 0.0])
    packed[1, 3:12] = 0.0
    packed[:, 12] = torch.tensor(
        [0, 1, 2, 3, 4, 5, 0, 1, 2, 99, -1, 2.7, 5, 1], device=dev)
    packed[:, 13] = (torch.arange(SHADE_TRIS, device=dev) % 3 == 0).float()
    packed[:, 14] = (torch.arange(SHADE_TRIS, device=dev) % 5 == 1).float()
    mat = dict(
        type=torch.tensor([0, 1, 2, 3, 1, 7], dtype=torch.int32, device=dev),
        alpha=torch.tensor([0.0, 0.0, 0.3, 0.2, 0.25, 0.1], device=dev),
        ior=torch.tensor([1.0, 1.5, 1.5, 1.2, 1.33, 1.5], device=dev),
        color=uni(6, 3))
    hit_i = torch.randint(-1, SHADE_TRIS, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    hit_i[::97] = SHADE_TRIS + 3
    direction = unit(n)
    flat = hit_i == 0
    direction[flat & (torch.arange(n, device=dev) % 2 == 0)] = torch.tensor(
        [1.0, 0.0, 0.0], device=dev)
    direction[flat & (torch.arange(n, device=dev) % 2 == 1)] = torch.tensor(
        [0.0, 0.0, -1.0], device=dev)
    u, v = uni(n), uni(n)
    hit_t = torch.where(hit_i < 0, float("inf"), uni(n) * 5)
    cur = dict(origin=uni(n, 3) * 4 - 2, direction=direction,
               normal=unit(n), color=uni(n, 3),
               c_importance=uni(n) + 0.1, l_importance=uni(n) + 0.1,
               tot_importance=uni(n) + 0.1,
               material=torch.randint(0, 6, (n,), generator=g, device=dev,
                                      dtype=torch.int32),
               triangle=torch.randint(-1, SHADE_TRIS, (n,), generator=g,
                                      device=dev, dtype=torch.int32),
               hit_light=torch.full((n,), -1, dtype=torch.int32, device=dev),
               hit_camera=torch.full((n,), -1, dtype=torch.int32,
                                     device=dev))
    if fc == "per_lane":
        flags = uni(n) < 0.5
    else:
        flags = torch.tensor(fc == "camera", device=dev).expand(n)
    key = rng.fold_in(rng.key(2**31 + 77, dev), depth)
    return dict(
        keys=rng.split(key, 3), depth=depth,
        hit=(hit_i, hit_t, u * 0.7, v * 0.7), cur=cur,
        active=uni(n) < 0.85, fwd_pending=uni(n) + 0.05, fc=flags,
        lanes=(torch.randperm(n, generator=g, device=dev) + 2**32 + 5)
        if rows else None,
        scene=dict(tri=dict(packed=packed), mat=mat),
        vertices={k: torch.zeros((6,) + tuple(x.shape), dtype=x.dtype,
                                 device=dev) for k, x in cur.items()},
        stored=torch.zeros((6, n), dtype=torch.bool, device=dev))


@pytest.mark.parametrize("depth", [0, 3])
@pytest.mark.parametrize("rows", [False, True])
@pytest.mark.parametrize("fc", ["camera", "light", "per_lane"])
@pytest.mark.parametrize("reference", [False, True])
def test_trace_shade_kernel_equals_plain_on_its_edge_cases(
        dev, monkeypatch, reference, fc, rows, depth):
    """``_shade_case``'s lanes: the same bits from the kernel and
    ``shade_plain`` on every output, under both estimators, a scalar or a
    per-lane from_camera, with and without rows.  At depth 0 the kernel
    leaves the rays it was given as they were and writes new ones; past it
    it writes the next rays over them (a lane that does not continue keeps
    its ray, as the plain version's)."""
    from clive2_tpu_torch.integrator import trace

    monkeypatch.setattr(constants, "REFERENCE_MIS", reference)
    a = _shade_case(dev, fc, rows, depth)
    diffs, got, k = _shade_both(a, trace.shade_kernel)
    assert not diffs, diffs
    assert (got[0] is k["cur"]) == (depth > 0)
    if depth == 0:
        assert all(torch.equal(k["cur"][f], a["cur"][f]) for f in a["cur"])
    assert bool(got[1].any()) and not bool(got[1].all())


@pytest.mark.parametrize("preset", ["cornell", "teapots"])
def test_a_sample_shades_each_bounce_in_one_launch(dev, connect_scenes,
                                                   preset):
    """One ``Renderer.run_sample`` launches the shading kernel once a
    bounce, 6 times, and never calls its plain version; the wrapper reads
    no device value on the host (CUDA's sync debug mode raises on one)."""
    from clive2_tpu_torch.integrator import trace
    from clive2_tpu_torch.testing import (TRACE_KERNELS, TRACE_PLAIN,
                                          launch_counters)

    counters = launch_counters()
    names = TRACE_KERNELS + TRACE_PLAIN
    r = ct.Renderer(connect_scenes[preset], seed=2**31 + 3, device=dev)
    before = [getattr(*counters[k]) for k in names]
    r.run_sample()
    torch.cuda.synchronize()
    after = [getattr(*counters[k]) for k in names]
    assert [x - y for x, y in zip(after, before)] == [6, 0]
    assert np.isfinite(r.raw_image).all() and r.raw_image.mean() > 0
    a = _shade_case(dev, "per_lane", True, 2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trace.shade_kernel(**a)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_trace_shade_kernel_neither_spills_nor_keeps_a_stack_frame(dev):
    """ptxas's report on csrc/shade.cu: its six instances (rows given or
    not; the reference estimator, the corrected one at depth 0 and past
    it) keep every value in registers.  The one stack frame is sinf's and
    cosf's argument reduction for |x| past 105,615 (seven words, 32
    bytes), which no angle here reaches."""
    from clive2_tpu_torch import kernels

    kernels.load()
    parts = kernels.ptxas_report("shade.cu").split(
        "Compiling entry function")[1:]
    assert len(parts) == 6
    for part in parts:
        assert "0 bytes spill stores, 0 bytes spill loads" in part, part
        assert "32 bytes stack frame" in part, part
