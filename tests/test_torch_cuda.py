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


def test_brute_kernel_matches_plain_on_the_pretest_edges(dev):
    """Rays at the edges of the exact test (clive2_tpu_torch.testing:
    brute_edge_cases): u underflowing to -0.0, a = +-0, u and v exactly 0
    or 1, u + v = 1, t at kDelta, each ray against both edge triangles; and
    rays inside the Cornell box, most of whose tests the pre-test would
    end (brute.pretest_stage on the card)."""
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
    stage = brute.pretest_stage(o, d, table)
    assert (stage < 3).float().mean() > 0.5


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


QUEUED = {"tf32": (0, 1 << 22), "fp32": (0, 1 << 22),
          "tf32-tail": (2000, 7000), "fp32-tail": (2000, 7000)}
# instance: (tail_min, chunk)


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
            s2.KernelSteps(tables, any_hit, case[:4]), got, chunk=chunk,
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
    plain steps on the same state; the prefilter keeps every slot the
    exact test accepts."""
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
    before = st_k.clone()
    keep = torch.zeros(st_k.max_tiles * 128, 4, dtype=torch.int32,
                       device=dev)
    fp32 = st_k.clone()
    s2.leaf_test(st_k, tables, "tf32", keep)
    s2.leaf_test(fp32, tables, "fp32")
    s2.leaf_test_plain(st_p, tables)
    for st in (st_k, fp32):
        assert torch.equal(st.bt, st_p.bt) and torch.equal(st.bc, st_p.bc)

    pos, f = s2.queue_positions(before)
    r = before.queue[pos].long()
    width = s2._width(tables)
    col = torch.arange(width, device=dev)
    kept = ((keep[pos][:, col // 32] >> (col % 32)) & 1).bool()
    row = before.ray[r]
    plain = s2.tf32_filter_plain(tables, f, row, before.bt[r], width)
    ok, t, _ = s2.slot_pass(tables, f, row[:, 3:6].unbind(-1),
                            row[:, 9:12].unbind(-1),
                            row[:, 12:15].unbind(-1), width)
    need = ok & (t <= before.bt[r, None])
    assert not (need & ~kept).any() and not (need & ~plain).any()
    assert (kept == plain).float().mean() > 0.999
    pairs = (tables["fat_start"][f + 1] - tables["fat_start"][f]).sum()
    assert kept.sum() < 0.5 * pairs

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
