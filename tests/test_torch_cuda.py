"""Kernel tests that need an NVIDIA GPU (marker ``cuda``); without a card
they skip.  The card's machine has no JAX, so run them there without the
suite's conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel must match its plain PyTorch version on every ray (ids; t, u, v
to 1e-6; built with --fmad=false both round alike; the fat-leaf, streaming
and wide kernels' any-hit ids too, since each stops where its plain version
does), and a small render on the card must match the same render on the
CPU.
"""

import numpy as np
import pytest
import torch

import clive2_tpu_torch as ct
from clive2_tpu_torch.bvh.build import build_bvh, leaf_tables
from clive2_tpu_torch.geometry import TriangleSoup
from clive2_tpu_torch.ops import brute, intersect, traverse_bvh2
from clive2_tpu_torch.ops import traverse_stream, traverse_stream2
from clive2_tpu_torch.ops import traverse_wide

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


@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh2_kernel_matches_gather_walk(dev, any_hit):
    gen = torch.Generator(device=dev).manual_seed(2)
    soup = _soup(2, 3000)
    bvh = build_bvh(soup)
    rows = intersect.pack_gather_walk(bvh, leaf_tables(bvh, soup))
    scene = dict(
        bvh={k: torch.from_numpy(v).to(dev) for k, v in rows.items()},
        bvh2={k: torch.from_numpy(v).to(dev) for k, v in
              traverse_bvh2.pack_bvh2(rows["node_packed"],
                                      rows["leaf_packed"]).items()})
    o, d, active, t_max = _rays(gen, 50_000, dev)
    got = traverse_bvh2.intersect_bvh2(o, d, scene, active=active,
                                       t_max=t_max, any_hit=any_hit)
    want = intersect.intersect_bvh_packed(o, d, scene["bvh"], active=active,
                                          t_max=t_max)
    _assert_same(got, want, closest=not any_hit)


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
    want = getattr(module, plain)(o, d, scene[name], scene["bvh"],
                                  active=active, t_max=t_max, any_hit=any_hit)
    _assert_same(got, want)
    assert (got[0] >= 0).sum() > 1000
    if not any_hit:
        _assert_same(got, intersect.intersect_bvh_packed(
            o, d, scene["bvh"], active=active, t_max=t_max))


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
