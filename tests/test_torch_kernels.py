"""The port's launch path (clive2_tpu_torch/kernels.py: ``call``, ``ptr``,
``RayArgs.pointers``) on the CPU, with a fake library and fake device and
stream reads put in its place: each argument goes to the entry as given,
followed by the stream read at that call; a device guard is entered only
for another card than the current one; a failed launch raises with the
entry's name and CUDA's message.  And every entry of ``_SIGNATURES`` is a
C entry of csrc/*.cu with as many parameters, of the same kinds.  The
real reads and launches are pinned on the card (tests/test_torch_cuda.py).
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
