"""The port's launch path (clive2_tpu_torch/kernels.py: ``call``, ``ptr``,
``RayArgs.pointers``) on the CPU, with a fake library and fake device and
stream reads put in its place: each argument goes to the entry as given,
followed by the stream read at that call; a device guard is entered only
for another card than the current one; a failed launch raises with the
entry's name and CUDA's message.  And every entry of ``_SIGNATURES`` is a
C entry of csrc/*.cu with as many parameters, of the same kinds.  The
real reads and launches are pinned on the card (tests/test_torch_cuda.py).
The connection's wrappers (integrator/connect.py) pass their arguments in
the order of their C entries and refuse what the kernels do not take; on
the CPU ``connect_paths`` runs the plain versions.  So do the RNG's
(rng.py: ``uniform_kernel``, ``keys_kernel``): a key off the CPU takes
them, a key on the CPU the plain versions.  The trace's shading wrapper
(integrator/trace.py: ``shade_kernel``) passes its arguments in the order
of ``clive2_trace_shade`` and refuses what the kernel does not take; on
the CPU ``trace_subpaths`` runs ``shade_plain``; ``check_launches``
refuses a card render whose shading ran plain.
"""

import contextlib
import ctypes
import glob
import os
import re

import pytest
import torch

from clive2_tpu_torch import kernels

CSRC = os.path.join(os.path.dirname(__file__), "..", "clive2_tpu_torch",
                    "csrc")


class FakeLibrary:
    """Stands for the loaded library: ``clive2_error_string``."""

    @staticmethod
    def clive2_error_string(rc):
        return f"fake error {rc}".encode()


@pytest.fixture
def fake(monkeypatch):
    """Entries that record their arguments and return ``rc[name]``; in
    place of PyTorch's private reads, the current device 0 and a stream
    read that gives the next handle of ``streams`` and records the device
    it was read for; a device guard that records the device."""
    state = dict(calls=[], rc={}, streams=[], reads=[], guards=[])

    def entry(name):
        def fn(*args):
            state["calls"].append((name, args))
            return state["rc"].get(name, 0)
        return fn

    def stream(index):
        state["reads"].append(index)
        return state["streams"].pop(0)

    @contextlib.contextmanager
    def guard(index):
        state["guards"].append(index)
        yield

    monkeypatch.setattr(kernels, "_lib", FakeLibrary())
    monkeypatch.setattr(kernels, "_entries", {
        name: entry(name) for name in ("clive2_a", "clive2_b")})
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", stream,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "device", guard)
    return state


def test_call_passes_the_arguments_and_the_stream_read_at_that_call(fake):
    fake["streams"] += [0x1000, 0x2000]
    dev = torch.device("cuda", 0)
    args = (123456789, None, 7, -1, 2 ** 40)
    kernels.call("clive2_a", dev, *args)
    kernels.call("clive2_b", dev, 5)
    assert fake["calls"] == [("clive2_a", args + (0x1000,)),
                             ("clive2_b", (5, 0x2000))]
    assert fake["reads"] == [0, 0] and fake["guards"] == []


def test_call_under_two_streams_passes_two_handles(fake):
    """The stream is read at every call, never kept from the last."""
    fake["streams"] += [11, 22, 22, 11]
    dev = torch.device("cuda", 0)
    for _ in range(4):
        kernels.call("clive2_a", dev, 1)
    assert [c[1][-1] for c in fake["calls"]] == [11, 22, 22, 11]


def test_call_enters_a_device_guard_only_for_another_card(fake):
    fake["streams"] += [1, 2, 3]
    kernels.call("clive2_a", torch.device("cuda"), 0)       # current card
    kernels.call("clive2_a", torch.device("cuda", 0), 0)
    assert fake["guards"] == [] and fake["reads"] == [0, 0]
    kernels.call("clive2_a", torch.device("cuda", 1), 0)
    assert fake["guards"] == [1] and fake["reads"] == [0, 0, 1]


def test_call_raises_with_the_entry_name_and_the_error_string(fake):
    fake["streams"] += [1]
    fake["rc"]["clive2_b"] = 700
    with pytest.raises(RuntimeError, match=re.escape(
            "clive2_b: launch failed with CUDA error 700 (fake error 700)")):
        kernels.call("clive2_b", torch.device("cuda", 0), 3)
    assert fake["calls"] == [("clive2_b", (3, 1))]


def test_call_loads_the_library_for_an_entry_not_bound_yet(fake,
                                                           monkeypatch):
    loads = []

    def load():
        loads.append(1)
        kernels._entries["clive2_c"] = lambda *args: 0

    monkeypatch.setattr(kernels, "load", load)
    fake["streams"] += [1, 2]
    kernels.call("clive2_c", torch.device("cuda", 0))
    kernels.call("clive2_c", torch.device("cuda", 0))
    assert loads == [1]
    with pytest.raises(KeyError):
        kernels.call("clive2_missing", torch.device("cuda", 0))


def test_ptr_and_ray_pointers_are_plain_ints():
    t = torch.arange(12.0).reshape(4, 3)
    assert kernels.ptr(t) == t.data_ptr() and type(kernels.ptr(t)) is int
    rays = kernels.RayArgs(t, t.clone(), torch.ones(4, dtype=torch.bool),
                           torch.full((4,), 2.0))
    got = rays.pointers()
    assert got == (t.data_ptr(), rays.direction.data_ptr(),
                   rays.active.data_ptr(), rays.t_max.data_ptr(), 4)
    assert all(type(v) is int for v in got)


def _c_entries():
    """{name: [parameter kinds]} of every ``extern "C" int`` entry in
    csrc/*.cu: "p" a pointer, "i" an int, "l" a long long."""
    out = {}
    for path in glob.glob(os.path.join(CSRC, "*.cu")):
        src = open(path).read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                kinds.append("p" if "*" in p else
                             "l" if p.startswith("long long") else
                             "i" if p.startswith("int ") else p)
            out[name] = kinds
    return out


KIND = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_int64: "l"}


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_every_signature_is_a_c_entry_of_the_sources(name):
    entries = _c_entries()
    assert name in entries, f"no extern \"C\" int {name}(...) in csrc/*.cu"
    assert [KIND[t] for t in kernels._SIGNATURES[name]] == entries[name]


# ---- the connection's wrappers (integrator/connect.py) ----------------------

CONNECT_W, CONNECT_H = 8, 6


@pytest.fixture(scope="module")
def cpu_connect():
    """The Cornell box at 8x6 on the CPU, one raster sample's subpaths as
    ``connect_paths`` receives them, and its connection cast."""
    import clive2_tpu_torch as ct
    from clive2_tpu_torch import rng
    from clive2_tpu_torch.integrator import connect, render

    scene = ct.create_scene_from_preset("empty", CONNECT_W, CONNECT_H,
                                        device="cpu")
    w = render.trace_wavefront(rng.key(3), scene.data, CONNECT_W, CONNECT_H)
    pairs = connect.connection_pairs()
    o, d, active, t_max = connect.connection_rays_plain(
        w["cam_path"], w["light_path"], scene.data, pairs, None, None, True)
    tri, t = connect.cast_connections(o, d, active, t_max, scene.data, True,
                                      None)
    return scene.data, w["cam_path"], w["light_path"], tri, t, active


@pytest.fixture
def fake_connect(fake, monkeypatch):
    """``fake`` with the connection's two entries."""
    def entry(name):
        def fn(*args):
            fake["calls"].append((name, args))
            return 0
        return fn

    monkeypatch.setattr(kernels, "_entries", {
        n: entry(n) for n in ("clive2_connect_rays", "clive2_connect_shade")})
    fake["streams"] += [7] * 8
    return fake


def _fields(path, names):
    return [path["vertices"][k].data_ptr() for k in names]


def test_connect_rays_wrapper_passes_its_arguments_in_order(cpu_connect,
                                                            fake_connect):
    """Each subpath's origin, normal and material with their depth stride
    (2N: views of the merged trace), lengths, N, depth, the material types,
    the camera, the pairs as a host array, any_hit, then the four outputs
    and the stream; one launch counted."""
    from clive2_tpu_torch.integrator import connect

    data, cam, light, _, _, _ = cpu_connect
    n = cam["length"].shape[0]
    pairs = connect.connection_pairs(3)
    before = connect.rays_kernel.launches
    out = connect.rays_kernel(cam, light, data, pairs, False)
    (name, args), = fake_connect["calls"]
    assert name == "clive2_connect_rays"
    fields = ("origin", "normal", "material")
    want = (_fields(cam, fields) + [2 * n] + _fields(light, fields)
            + [2 * n, cam["length"].data_ptr(), light["length"].data_ptr(),
               n, 3, data["mat"]["type"].data_ptr(), 8]
            + [data["camera"][k].data_ptr()
               for k in ("center", "focal_point", "direction")])
    assert list(args[:len(want)]) == want
    host = ctypes.cast(args[len(want)], ctypes.POINTER(ctypes.c_int))
    assert [host[i] for i in range(18)] == [v for ts in pairs for v in ts]
    assert args[len(want) + 1:len(want) + 3] == (9, 0)
    assert list(args[len(want) + 3:-1]) == [x.data_ptr() for x in out]
    assert args[-1] == 7 and connect.rays_kernel.launches == before + 1
    assert [tuple(x.shape) for x in out] == [(9, n, 3), (9, n, 3), (9, n),
                                            (9, n)]
    assert out[2].dtype == torch.bool


def test_connect_shade_wrapper_passes_its_arguments_in_order(
        cpu_connect, fake_connect, monkeypatch):
    """The camera subpath's ten fields and stride, the light subpath's nine
    and stride, the camera lengths, N, max_bounces, the cast, the material
    table, the packed triangle rows, the camera's seven tensors, the image
    size, the estimator read at the call, the four outputs (the light
    images zeroed) and the stream."""
    from clive2_tpu_torch import constants
    from clive2_tpu_torch.integrator import connect

    data, cam, light, tri, t, active = cpu_connect
    monkeypatch.setattr(constants, "REFERENCE_MIS", True)
    n = cam["length"].shape[0]
    before = connect.shade_kernel.launches
    out = connect.shade_kernel(cam, light, data, tri, t, active, CONNECT_W,
                               CONNECT_H)
    (name, args), = fake_connect["calls"]
    assert name == "clive2_connect_shade"
    fields = ("origin", "direction", "normal", "color", "c_importance",
              "l_importance", "tot_importance", "material", "triangle")
    mat, packed = data["mat"], data["tri"]["packed"]
    want = (_fields(cam, fields + ("hit_light",)) + [2 * n]
            + _fields(light, fields) + [2 * n, cam["length"].data_ptr(), n,
                                        6]
            + [x.data_ptr() for x in (tri, t, active)]
            + [mat[k].data_ptr() for k in ("type", "color", "emission")]
            + [8, packed.data_ptr(), 16, packed.shape[0]]
            + [data["camera"][k].data_ptr()
               for k in ("center", "focal_point", "direction", "dx", "dy",
                         "phys_width", "phys_height")]
            + [CONNECT_W, CONNECT_H, 1] + [x.data_ptr() for x in out] + [7])
    assert list(args) == want
    assert connect.shade_kernel.launches == before + 1
    assert [tuple(x.shape) for x in out] == [
        (n, 3), (n,), (CONNECT_W * CONNECT_H, 3), (CONNECT_W * CONNECT_H,)]
    assert not out[2].any() and not out[3].any()


def _with_field(path, name, value):
    return dict(path, vertices=dict(path["vertices"], **{name: value}))


REFUSALS = {
    "wrong dtype": lambda cam: _with_field(
        cam, "material", cam["vertices"]["material"].long()),
    "non-contiguous field": lambda cam: _with_field(
        cam, "normal",
        cam["vertices"]["normal"].transpose(0, 1).contiguous()
        .transpose(0, 1)),
    "fields at other strides": lambda cam: _with_field(
        cam, "origin", cam["vertices"]["origin"].contiguous()),
}


@pytest.mark.parametrize("case", list(REFUSALS))
@pytest.mark.parametrize("stage", ["rays", "shade"])
def test_connect_wrappers_refuse_what_the_kernels_do_not_take(
        cpu_connect, fake_connect, stage, case):
    from clive2_tpu_torch.integrator import connect

    data, cam, light, tri, t, active = cpu_connect
    cam = REFUSALS[case](cam)
    with pytest.raises(ValueError):
        if stage == "rays":
            connect.rays_kernel(cam, light, data, connect.connection_pairs(),
                                True)
        else:
            connect.shade_kernel(cam, light, data, tri, t, active,
                                 CONNECT_W, CONNECT_H)
    assert fake_connect["calls"] == []


def test_connect_wrappers_refuse_past_max_bounces(cpu_connect,
                                                  fake_connect):
    """max_bounces past MAX_BOUNCES (or past the subpaths' depth), pairs
    outside [1, MAX_BOUNCES], a cast of another shape."""
    from clive2_tpu_torch.integrator import connect

    data, cam, light, tri, t, active = cpu_connect
    with pytest.raises(ValueError, match="max_bounces"):
        connect.shade_kernel(cam, light, data, tri, t, active, CONNECT_W,
                             CONNECT_H, 7)
    with pytest.raises(ValueError, match="pairs"):
        connect.rays_kernel(cam, light, data, connect.connection_pairs(7),
                            True)
    with pytest.raises(ValueError, match="cast"):
        connect.shade_kernel(cam, light, data, tri, t, active, CONNECT_W,
                             CONNECT_H, 5)
    assert fake_connect["calls"] == []


def test_connect_paths_on_the_cpu_runs_the_plain_versions(cpu_connect):
    """On CPU tensors each stage's plain version runs once a call and
    neither kernel launches; the four counts are registered."""
    from clive2_tpu_torch.integrator import connect
    from clive2_tpu_torch.testing import launch_counters

    data, cam, light, _, _, _ = cpu_connect
    counters = launch_counters()
    names = ("connect_rays", "connect_shade", "connect_rays_plain",
             "connect_shade_plain")
    before = [getattr(*counters[k]) for k in names]
    for debug in (False, True):
        connect.connect_paths(cam, light, data, CONNECT_W, CONNECT_H,
                              debug_per_strategy=debug)
    after = [getattr(*counters[k]) for k in names]
    assert [a - b for a, b in zip(after, before)] == [0, 0, 2, 2]


# ---- the RNG's wrappers (rng.py, csrc/rng.cu) --------------------------------

@pytest.fixture
def fake_rng(fake, monkeypatch):
    """``fake`` with the RNG's two entries."""
    def entry(name):
        def fn(*args):
            fake["calls"].append((name, args))
            return 0
        return fn

    monkeypatch.setattr(kernels, "_entries", {
        n: entry(n) for n in ("clive2_rng_uniform", "clive2_rng_keys")})
    fake["streams"] += [7] * 8
    return fake


@pytest.mark.parametrize("bits", [False, True])
def test_rng_uniform_wrapper_passes_its_arguments_in_order(fake_rng, bits):
    """The key, the rows (a null pointer without them), the row count, the
    inner size, the bits flag, the output and the stream; the output's
    shape and dtype those of ``uniform`` (float32) or ``random_bits``
    (int64); one launch counted a draw."""
    from clive2_tpu_torch import rng

    k = rng.key(11)
    rows = torch.tensor([5, 0, 9], dtype=torch.int64)
    before = rng.uniform_kernel.launches
    a = rng.uniform_kernel(k, (10, 2), bits=bits)
    b = rng.uniform_kernel(k, (10, 4, 3), rows, bits=bits)
    c = rng.uniform_kernel(k, (), bits=bits)
    dtype = torch.int64 if bits else torch.float32
    assert [(tuple(x.shape), x.dtype) for x in (a, b, c)] == [
        ((10, 2), dtype), ((3, 4, 3), dtype), ((), dtype)]
    assert fake_rng["calls"] == [
        ("clive2_rng_uniform", (k.data_ptr(), None, 10, 2, int(bits),
                                a.data_ptr(), 7)),
        ("clive2_rng_uniform", (k.data_ptr(), rows.data_ptr(), 3, 12,
                                int(bits), b.data_ptr(), 7)),
        ("clive2_rng_uniform", (k.data_ptr(), None, 1, 1, int(bits),
                                c.data_ptr(), 7))]
    assert rng.uniform_kernel.launches == before + 3


def test_rng_keys_wrapper_passes_its_arguments_in_order(fake_rng):
    """The key, the first counter, the count, the output and the stream:
    ``fold_in``'s (data, 1) and ``split``'s (0, num); one launch counted a
    call, none for no keys."""
    from clive2_tpu_torch import rng

    k = rng.split(rng.key(4), 3)[1]
    before = rng.keys_kernel.launches
    one = rng.keys_kernel(k, 2**32 - 1, 1)
    three = rng.keys_kernel(k, 0, 3)
    none = rng.keys_kernel(k, 0, 0)
    assert [tuple(x.shape) for x in (one, three, none)] == [(1, 2), (3, 2),
                                                            (0, 2)]
    assert {x.dtype for x in (one, three, none)} == {torch.int64}
    assert fake_rng["calls"] == [
        ("clive2_rng_keys", (k.data_ptr(), 2**32 - 1, 1, one.data_ptr(), 7)),
        ("clive2_rng_keys", (k.data_ptr(), 0, 3, three.data_ptr(), 7))]
    assert rng.keys_kernel.launches == before + 2


def test_rng_keys_off_the_cpu_take_the_kernels(fake_rng):
    """``fold_in``, ``split``, ``uniform`` and ``random_bits`` on a key
    that is not on the CPU (here on PyTorch's meta device) launch one
    kernel each and call no plain version; rows of another integer type
    are made int64 on the key's device first, as the plain version makes
    them; ``fold_in`` takes its data to 32 bits."""
    from clive2_tpu_torch import rng
    from clive2_tpu_torch.testing import (RNG_KERNELS, RNG_PLAIN,
                                          launch_counters)

    counters = launch_counters()
    names = RNG_KERNELS + RNG_PLAIN
    before = [getattr(*counters[n]) for n in names]
    k = torch.empty(2, dtype=torch.int64, device="meta")
    assert rng.fold_in(k, -1).shape == (2,)
    assert rng.split(k, 3).shape == (3, 2)
    lanes = torch.tensor([3, 1], dtype=torch.int32)
    u = rng.uniform(k, (6, 2), rows=lanes)
    bits = rng.random_bits(k, (6,))
    assert (u.shape, u.dtype, u.device.type) == ((2, 2), torch.float32,
                                                 "meta")
    assert (bits.shape, bits.dtype) == ((6,), torch.int64)
    assert [c[0] for c in fake_rng["calls"]] == [
        "clive2_rng_keys", "clive2_rng_keys", "clive2_rng_uniform",
        "clive2_rng_uniform"]
    assert fake_rng["calls"][0][1][1:3] == (2**32 - 1, 1)
    assert fake_rng["calls"][2][1][2:5] == (2, 2, 0)
    after = [getattr(*counters[n]) for n in names]
    assert [x - y for x, y in zip(after, before)] == [2, 2, 0, 0, 0]


def test_rng_fold_in_off_the_cpu_refuses_tensor_data(fake_rng):
    """Off the CPU ``fold_in`` routes by the key's device alone: tensor
    data is refused, with no launch and no plain hash on the card."""
    from clive2_tpu_torch import rng
    from clive2_tpu_torch.testing import (RNG_KERNELS, RNG_PLAIN,
                                          launch_counters)

    counters = launch_counters()
    names = RNG_KERNELS + RNG_PLAIN
    before = [getattr(*counters[n]) for n in names]
    k = torch.empty(2, dtype=torch.int64, device="meta")
    for data in (torch.tensor(5), torch.tensor(5, device="meta")):
        with pytest.raises(TypeError):
            rng.fold_in(k, data)
    assert fake_rng["calls"] == []
    after = [getattr(*counters[n]) for n in names]
    assert after == before


RNG_REFUSALS = {
    "rows of int32": lambda k: rng_draw(k, torch.arange(3, dtype=torch.int32)),
    "non-contiguous rows": lambda k: rng_draw(
        k, torch.arange(6, dtype=torch.int64)[::2]),
    "rows of two dimensions": lambda k: rng_draw(
        k, torch.zeros((3, 1), dtype=torch.int64)),
    "rows on another device": lambda k: rng_draw(
        k.to("meta"), torch.arange(3, dtype=torch.int64)),
    "a key of int32": lambda k: rng_draw(k.to(torch.int32)),
    "a key of three words": lambda k: rng_draw(torch.cat([k, k[:1]])),
    "a non-contiguous key": lambda k: rng_draw(torch.stack([k, k], 1)[:, 0]),
    "a negative size": lambda k: _rng().uniform_kernel(k, (4, -2)),
    "keys past 2^31": lambda k: _rng().keys_kernel(k, 0, 2**31),
    "a counter past 32 bits": lambda k: _rng().keys_kernel(k, 2**32, 1),
    "a key of int32 to derive from": lambda k: _rng().keys_kernel(
        k.to(torch.int32), 0, 2),
}


def _rng():
    from clive2_tpu_torch import rng
    return rng


def rng_draw(k, rows=None):
    return _rng().uniform_kernel(k, (4, 2), rows)


@pytest.mark.parametrize("case", list(RNG_REFUSALS))
def test_rng_wrappers_refuse_what_the_kernels_do_not_take(fake_rng, case):
    from clive2_tpu_torch import rng

    with pytest.raises(ValueError):
        RNG_REFUSALS[case](rng.key(9))
    assert fake_rng["calls"] == []


def test_rng_on_the_cpu_runs_the_plain_versions():
    """A key on the CPU: each draw, fold and split calls its plain version
    once and launches no kernel; ``uniform`` is ``uniform_plain``."""
    from clive2_tpu_torch import rng
    from clive2_tpu_torch.testing import (RNG_KERNELS, RNG_PLAIN,
                                          launch_counters)

    counters = launch_counters()
    names = RNG_KERNELS + RNG_PLAIN
    before = [getattr(*counters[n]) for n in names]
    k = rng.fold_in(rng.key(3), 7)
    ka, kb = rng.split(k)
    u = rng.uniform(ka, (5, 2), rows=torch.tensor([4, 0]))
    assert torch.equal(u.view(torch.int32), rng.uniform_plain(
        ka, (5, 2), torch.tensor([4, 0])).view(torch.int32))
    rng.random_bits(kb, (3,))
    after = [getattr(*counters[n]) for n in names]
    assert [x - y for x, y in zip(after, before)] == [0, 0, 3, 1, 1]


# ---- the trace's shading wrapper (integrator/trace.py, csrc/shade.cu) --------

@pytest.fixture
def fake_shade(fake, monkeypatch):
    """``fake`` with the shading's entry."""
    def fn(*args):
        fake["calls"].append(("clive2_trace_shade", args))
        return 0

    monkeypatch.setattr(kernels, "_entries", {"clive2_trace_shade": fn})
    fake["streams"] += [7] * 8
    return fake


def _shade_args(device="cpu", n=5, depth_max=6, rows=9, tris=4):
    """``shade_kernel``'s keyword arguments at depth 0: ``n`` lanes of rays,
    hits, flags, keys and lanes, ``depth_max`` vertices to fill, a scene
    of ``tris`` packed triangle rows and ``rows`` materials."""
    def f(*shape):
        return torch.zeros(shape, device=device)

    def i(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    cur = dict(origin=f(n, 3), direction=f(n, 3), normal=f(n, 3),
               color=f(n, 3), c_importance=f(n), l_importance=f(n),
               tot_importance=f(n), material=i(n), triangle=i(n),
               hit_light=i(n), hit_camera=i(n))
    return dict(
        keys=torch.zeros((3, 2), dtype=torch.int64, device=device), depth=0,
        hit=(i(n), f(n), f(n), f(n)), cur=cur,
        active=torch.ones(n, dtype=torch.bool, device=device),
        fwd_pending=f(n),
        fc=torch.ones((), dtype=torch.bool, device=device).expand(n),
        lanes=torch.arange(n, device=device),
        scene=dict(tri=dict(packed=f(tris, 16)),
                   mat=dict(alpha=f(rows), ior=f(rows), type=i(rows),
                            color=f(rows, 3))),
        vertices={k: torch.empty((depth_max,) + tuple(v.shape),
                                 dtype=v.dtype, device=device)
                  for k, v in cur.items()},
        stored=torch.empty((depth_max, n), dtype=torch.bool, device=device))


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("reference", [False, True])
def test_trace_shade_wrapper_passes_its_arguments_in_order(
        fake_shade, monkeypatch, depth, reference):
    """The current rays' 11 fields, the next rays' (new tensors at depth 0,
    the current ones after it: the caller's rays are never written), vertex
    ``depth``'s row of each field, the hit, active, the pending pdfs,
    ``stored``'s row, from_camera and its stride, the keys, the lanes, N,
    the depth, the packed rows with their stride and count, the material
    table and its count, the estimator read at the call, the stream; one
    launch counted; active and the pending pdfs returned as given."""
    from clive2_tpu_torch import constants
    from clive2_tpu_torch.integrator import trace

    monkeypatch.setattr(constants, "REFERENCE_MIS", reference)
    a = _shade_args()
    a["depth"] = depth
    before = trace.shade_kernel.launches
    nxt, active, pending = trace.shade_kernel(**a)
    (name, args), = fake_shade["calls"]
    assert name == "clive2_trace_shade"
    cur, fields = a["cur"], trace.RAY_FIELDS
    assert (nxt is cur) == (depth > 0)
    assert all(nxt[k].shape == cur[k].shape and nxt[k].dtype == cur[k].dtype
               and nxt[k].is_contiguous() for k in fields)
    if depth == 0:
        assert not {nxt[k].data_ptr() for k in fields} & {
            cur[k].data_ptr() for k in fields}
    packed, mat = a["scene"]["tri"]["packed"], a["scene"]["mat"]
    want = ([cur[k].data_ptr() for k in fields]
            + [nxt[k].data_ptr() for k in fields]
            + [a["vertices"][k][depth].data_ptr() for k in fields]
            + [h.data_ptr() for h in a["hit"]]
            + [a["active"].data_ptr(), a["fwd_pending"].data_ptr(),
               a["stored"][depth].data_ptr(), a["fc"].data_ptr(), 0,
               a["keys"].data_ptr(), a["lanes"].data_ptr(), 5, depth,
               packed.data_ptr(), 16, 4]
            + [mat[k].data_ptr() for k in ("alpha", "ior", "type", "color")]
            + [9, int(reference), 7])
    assert list(args) == want
    assert active is a["active"] and pending is a["fwd_pending"]
    assert trace.shade_kernel.launches == before + 1


def test_trace_shade_wrapper_takes_depths_past_max_bounces(fake_shade):
    """Subpaths of 12 vertices (the glass furnace oracle's): depth 11 is
    one launch, depth 12 is refused."""
    from clive2_tpu_torch.integrator import trace

    a = _shade_args(depth_max=12)
    trace.shade_kernel(**dict(a, depth=11))
    (_, args), = fake_shade["calls"]
    assert args[33 + 8 + 4] == 11
    with pytest.raises(ValueError):
        trace.shade_kernel(**dict(a, depth=12))
    assert len(fake_shade["calls"]) == 1


def test_trace_shade_wrapper_takes_per_lane_flags_and_no_lanes(fake_shade):
    """A contiguous per-lane from_camera goes in with stride 1, no lanes as
    a null pointer; no lanes at all launches nothing."""
    from clive2_tpu_torch.integrator import trace

    a = _shade_args()
    a["fc"] = torch.tensor([True, False, True, False, False])
    a["lanes"] = None
    trace.shade_kernel(**a)
    (_, args), = fake_shade["calls"]
    assert args[40:45] == (a["fc"].data_ptr(), 1, a["keys"].data_ptr(),
                           None, 5)
    before = trace.shade_kernel.launches
    trace.shade_kernel(**_shade_args(n=0))
    assert len(fake_shade["calls"]) == 1
    assert trace.shade_kernel.launches == before


def _with_ray(a, k, v):
    return dict(a, cur=dict(a["cur"], **{k: v}))


def _with_table(a, part, k, v):
    scene = dict(a["scene"])
    scene[part] = dict(scene[part], **{k: v})
    return dict(a, scene=scene)


SHADE_REFUSALS = {
    "depth MAX_BOUNCES of MAX_BOUNCES vertices": lambda a: dict(a, depth=6),
    "a depth past the stored vertices": lambda a: dict(
        _shade_args("meta", depth_max=3), depth=3),
    "a negative depth": lambda a: dict(a, depth=-1),
    "a ray field of another dtype": lambda a: _with_ray(
        a, "c_importance", a["cur"]["c_importance"].double()),
    "an id field of int64": lambda a: _with_ray(
        a, "triangle", a["cur"]["triangle"].long()),
    "a ray field of another shape": lambda a: _with_ray(
        a, "normal", a["cur"]["normal"][:, :2]),
    "a strided ray field": lambda a: _with_ray(
        a, "origin", a["cur"]["origin"].t().contiguous().t()),
    "an expanded ray field": lambda a: _with_ray(
        a, "normal", a["cur"]["normal"][:1].expand(5, 3)),
    "a missing ray field": lambda a: dict(a, cur={
        k: v for k, v in a["cur"].items() if k != "hit_camera"}),
    "a ray field on another device": lambda a: _with_ray(
        a, "color", torch.zeros(5, 3)),
    "vertices of another depth": lambda a: dict(a, vertices=dict(
        a["vertices"], origin=a["vertices"]["origin"][:4])),
    "stored of another dtype": lambda a: dict(
        a, stored=a["stored"].to(torch.uint8)),
    "a hit id of int64": lambda a: dict(
        a, hit=(a["hit"][0].long(),) + a["hit"][1:]),
    "a hit of another length": lambda a: dict(
        a, hit=a["hit"][:3] + (a["hit"][3][:4],)),
    "active of uint8": lambda a: dict(a, active=a["active"].to(torch.uint8)),
    "strided pending pdfs": lambda a: dict(
        a, fwd_pending=torch.zeros(10, device="meta")[::2]),
    "from_camera of uint8": lambda a: dict(a, fc=a["fc"].to(torch.uint8)),
    "from_camera two lanes apart": lambda a: dict(
        a, fc=torch.ones(10, dtype=torch.bool, device="meta")[::2]),
    "keys of int32": lambda a: dict(a, keys=a["keys"].int()),
    "one key": lambda a: dict(a, keys=a["keys"][:1]),
    "lanes of int32": lambda a: dict(a, lanes=a["lanes"].int()),
    "packed rows of 14 columns": lambda a: _with_table(
        a, "tri", "packed", torch.zeros(4, 14, device="meta")),
    "packed columns apart": lambda a: _with_table(
        a, "tri", "packed", torch.zeros(16, 4, device="meta").t()),
    "material types of int64": lambda a: _with_table(
        a, "mat", "type", a["scene"]["mat"]["type"].long()),
    "material colors of another count": lambda a: _with_table(
        a, "mat", "color", torch.zeros(8, 3, device="meta")),
}


@pytest.mark.parametrize("case", list(SHADE_REFUSALS))
def test_trace_shade_wrapper_refuses_what_the_kernel_does_not_take(
        fake_shade, case):
    from clive2_tpu_torch.integrator import trace

    before = trace.shade_kernel.launches
    a = SHADE_REFUSALS[case](_shade_args("meta"))
    with pytest.raises(ValueError):
        trace.shade_kernel(**a)
    assert fake_shade["calls"] == []
    assert trace.shade_kernel.launches == before


def test_trace_on_the_cpu_runs_the_plain_shading(fake_shade):
    """CPU tensors: every bounce of ``trace_subpaths`` calls ``shade_plain``
    once and launches nothing; the two counts are registered."""
    import clive2_tpu_torch as ct
    from clive2_tpu_torch import rng
    from clive2_tpu_torch.integrator import render
    from clive2_tpu_torch.testing import (TRACE_KERNELS, TRACE_PLAIN,
                                          launch_counters)

    counters = launch_counters()
    names = TRACE_KERNELS + TRACE_PLAIN
    before = [getattr(*counters[k]) for k in names]
    scene = ct.create_scene_from_preset("empty", 8, 6, device="cpu")
    path = render.trace_wavefront(rng.key(2), scene.data, 8, 6,
                                  max_bounces=4)
    after = [getattr(*counters[k]) for k in names]
    assert [x - y for x, y in zip(after, before)] == [0, 4]
    assert path["cam_path"]["valid"].shape == (4, 48)
    assert fake_shade["calls"] == []


@pytest.mark.parametrize("plain", ["trace_shade_plain", None])
def test_check_launches_refuses_a_render_whose_shading_ran_plain(plain):
    """A card render's counts: the shading kernel may run beside any cast
    kernel; its plain version may not, unless named as compared."""
    from clive2_tpu_torch.testing import check_launches, launch_counters

    ran = dict.fromkeys(launch_counters(), 0)
    ran.update(brute=7, connect_rays=1, connect_shade=1, rng_uniform=4,
               rng_keys=15, trace_shade=6)
    if plain is None:
        check_launches("cornell", ("brute",), ran)
        return
    ran[plain] = 6
    with pytest.raises(AssertionError, match="plain"):
        check_launches("cornell", ("brute",), ran)
    check_launches("cornell", ("brute",), ran, compared=(plain,))
