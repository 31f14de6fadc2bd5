"""Build, load and call the port's CUDA kernels (``csrc/*.cu``).

At first use ``nvcc`` compiles each ``.cu`` source in ``csrc/`` (which share
the device helpers of ``common.cuh``) into an object, one ``nvcc`` per
source, all started together, and links the objects into one
shared library with a plain C interface, in ``clive2_tpu_torch/build/``
(ignored by git), named by a hash of the sources and flags so an edit
rebuilds it.  ``ctypes`` loads it.  Each C entry point launches one kernel,
does not synchronise, and returns ``cudaGetLastError()``; ``call`` raises
when that is not 0.

The launch path (``call``) costs about what one PyTorch op costs on the
host (PERF.md): ``load`` binds each entry once with its ``argtypes``
(``_SIGNATURES``), so pointers (``tensor.data_ptr()``) and integers go in as
plain Python ints; the stream is read at every call as a raw handle, never
cached, so a launch lands on whatever stream is current, a CUDA graph's
capture stream or a side stream alike; and a device guard is entered only
for a tensor on another card than the current one.

Flags: ``sm_90a`` (Hopper) and ``--fmad=false``, so that a kernel rounds
exactly as its plain PyTorch version (separate multiplies and adds) and
their hit ids can be held equal on every ray.  The compiles also ask ptxas
for its resource report (``-Xptxas -v``: registers, shared memory, spills
per kernel), kept beside the library (``ptxas_report``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_RAYS = [_P, _P, _P, _P, ctypes.c_int64]     # origin, direction, active,
_OUTS = [_P, _P, _P, _P]                     # t_max, n | i, t, u, v
_SIGNATURES = {
    "clive2_brute": _RAYS + [_P, ctypes.c_int] + _OUTS + [_P],
    # nodes, tris, ray counter | any_hit
    "clive2_bvh2": _RAYS + [_P] * 3 + [ctypes.c_int] + _OUTS + [_P],
    "clive2_bvh2_info": [ctypes.c_int, _P],
    "clive2_stream2": _RAYS + [_P] * 7 + [ctypes.c_int] + _OUTS + [_P],
    # nodes, tris, ray counter | any_hit
    "clive2_wide": _RAYS + [_P] * 3 + [ctypes.c_int] + _OUTS + [_P],
    "clive2_wide_info": [ctypes.c_int, _P],
    # nodes, subs, tris, ray counter | any_hit
    "clive2_stream": _RAYS + [_P] * 4 + [ctypes.c_int] + _OUTS + [_P],
    "clive2_stream_info": [ctypes.c_int, _P],
    # the queued fat-leaf traversal (ops/traverse_stream2.py)
    "clive2_stream2_tail": [ctypes.c_int64] + [_P] * 13 + [ctypes.c_int]
    + _OUTS + [_P],
    "clive2_s2q_walk": [_P] * 4 + [ctypes.c_int64, ctypes.c_int] + [_P] * 11
    + [ctypes.c_int, _P],
    "clive2_s2q_count": [_P, ctypes.c_int64, _P, _P],
    "clive2_s2q_plan": [_P, ctypes.c_int, _P, _P, _P, _P],
    "clive2_s2q_scatter": [_P, ctypes.c_int64, _P, _P, _P],
    "clive2_s2q_leaf": [_P] * 4 + [ctypes.c_int64] + [_P] * 7,
    # nodes, tris, packet, variant, count | t, id, counts
    "clive2_packet_walk": _RAYS + [_P, _P] + [ctypes.c_int] * 3 + [_P] * 3
    + [_P],
    # a, o, n (csrc/link_probe.cu)
    "clive2_link_probe": [_P, _P, ctypes.c_int64, _P],
    # the layout probes (csrc/mosaic_probes.cu): src, rows, cols, band
    # rows, out | a, b, c, m, n, k, trans_a
    "clive2_slab_copy": [_P] + [ctypes.c_int] * 3 + [_P, _P],
    "clive2_mma_bf16": [_P] * 3 + [ctypes.c_int] * 4 + [_P],
    # the connection (csrc/connect.cu): each subpath's vertex fields and
    # their depth stride, lengths, n, depth, material types and count,
    # camera, host pairs and count, any_hit | origin, direction, active,
    # t_max
    "clive2_connect_rays": ([_P] * 3 + [ctypes.c_int64]) * 2 + [_P, _P]
    + [ctypes.c_int64, ctypes.c_int, _P, ctypes.c_int] + [_P] * 4
    + [ctypes.c_int] * 2 + [_P] * 4 + [_P],
    # the camera subpath's 10 fields and stride, the light subpath's 9 and
    # stride, camera lengths, n, max_bounces, the cast's tri, t, active,
    # material type, color, emission and count, packed rows, columns and
    # count, 7 camera tensors, width, height, reference | contribution,
    # weight sum, light image, light weights
    "clive2_connect_shade": [_P] * 10 + [ctypes.c_int64] + [_P] * 9
    + [ctypes.c_int64, _P, ctypes.c_int64, ctypes.c_int] + [_P] * 6
    + [ctypes.c_int, _P, ctypes.c_int, ctypes.c_int64] + [_P] * 7
    + [ctypes.c_int] * 3 + [_P] * 4 + [_P],
    # the threefry RNG (csrc/rng.cu): key, rows, row count, inner size,
    # bits | out; key, first counter, count | out
    "clive2_rng_uniform": [_P, _P, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int, _P, _P],
    "clive2_rng_keys": [_P, ctypes.c_int64, ctypes.c_int, _P, _P],
    # one bounce of the trace's shading (csrc/shade.cu): the current rays'
    # 11 fields, the next rays', vertex d's; the hit (i, t, u, v), active,
    # pending pdfs, stored, from_camera and its stride, keys, rows, n,
    # depth, packed rows, stride and count, material alpha, ior, type,
    # color and count, reference
    "clive2_trace_shade": [_P] * 33 + [_P] * 8 + [ctypes.c_int64]
    + [_P, _P, ctypes.c_int64, ctypes.c_int, _P, ctypes.c_int64,
       ctypes.c_int64] + [_P] * 4 + [ctypes.c_int, ctypes.c_int, _P],
}

_lib = None
_entries = {}      # entry name: its ctypes function, bound by load()


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "clive2_tpu_torch/csrc at first use")
    return path


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libclive2_kernels-{h.hexdigest()[:16]}.so")


def _run_all(commands):
    """Run the commands at once; raise with the output of those that
    failed, else return their outputs."""
    procs = []
    try:
        for cmd in commands:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    errors = [f"{os.path.basename(c[-1])}: nvcc failed "
              f"({p.returncode}):\n{out}"
              for c, p, out in zip(commands, procs, outs) if p.returncode]
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def build() -> tuple[str, float]:
    """Compile the kernels unless this exact build exists.  Returns the
    library path and the seconds spent compiling (0 when cached)."""
    so = library_path()
    if os.path.exists(so):
        return so, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cus = [s for s in sources() if s.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in cus]
        outs = _run_all([[nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                          o, s] for s, o in zip(cus, objs)])
        lib = os.path.join(tmp, "lib.so")
        _run_all([[nvcc(), *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        with open(os.path.join(tmp, "ptxas.txt"), "w") as f:
            f.writelines(f"== {os.path.basename(s)}\n{out}"
                         for s, out in zip(cus, outs))
        os.replace(os.path.join(tmp, "ptxas.txt"), so + ".ptxas.txt")
        os.replace(lib, so)          # atomic: concurrent builds race safely
    return so, time.perf_counter() - t0


def ptxas_report(source: str) -> str:
    """ptxas's report (``-Xptxas -v``) on the kernels of ``source`` (a file
    name in ``csrc/``) from the build of the current sources."""
    with open(library_path() + ".ptxas.txt") as f:
        text = f.read()
    part = text.split(f"== {source}\n", 1)[1]
    return part.split("\n== ", 1)[0]


def load():
    """The loaded kernel library (built on first call), each entry of
    ``_SIGNATURES`` bound into ``_entries``."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
            _entries[name] = fn
        lib.clive2_error_string.argtypes = [ctypes.c_int]
        lib.clive2_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, device, *args):
    """Launch kernel entry ``name`` on ``device``'s current stream, read at
    this call; ``args`` are the entry's arguments before the stream, as
    ints (pointers from ``ptr``) or None for a null pointer.

    The current device and stream are read through PyTorch's private
    ``torch._C._cuda_getDevice`` and ``torch._C._cuda_getCurrentRawStream``
    (a raw handle, without the ``Stream`` object that
    ``torch.cuda.current_stream`` builds); a card test pins both to the
    public calls."""
    fn = _entries.get(name) or _bind(name)
    here = torch._C._cuda_getDevice()
    index = device.index
    if index is None or index == here:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(here))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc:
        msg = _lib.clive2_error_string(rc).decode()
        raise RuntimeError(f"{name}: launch failed with CUDA error {rc} "
                           f"({msg})")


def _bind(name: str):
    """Entry ``name``, loading the library first (KeyError: no such
    entry)."""
    load()
    return _entries[name]


def ptr(t) -> int:
    return t.data_ptr()


@dataclasses.dataclass
class RayArgs:
    """Validated, contiguous ray tensors for a kernel launch; holds them
    alive for the duration of the call."""

    origin: torch.Tensor
    direction: torch.Tensor
    active: torch.Tensor
    t_max: torch.Tensor

    @property
    def n(self) -> int:
        return self.origin.shape[0]

    def pointers(self):
        return (self.origin.data_ptr(), self.direction.data_ptr(),
                self.active.data_ptr(), self.t_max.data_ptr(), self.n)


def ray_args(origin, direction, active=None, t_max=None) -> RayArgs:
    if origin.device.type != "cuda":
        raise ValueError(f"kernels take CUDA tensors, got {origin.device}")
    dev = origin.device
    n = origin.shape[0]
    for name, t in (("origin", origin), ("direction", direction)):
        if t.dtype != torch.float32 or tuple(t.shape) != (n, 3):
            raise ValueError(f"{name} must be f32 [N, 3], got "
                             f"{tuple(t.shape)} {t.dtype}")
        on_device(t, dev, name)
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    if active.dtype not in (torch.bool, torch.uint8) or active.shape != (n,):
        raise ValueError("active must be bool or uint8 [N]")
    if t_max is None:
        t_max = torch.full((n,), float("inf"), device=dev)
    if t_max.dtype != torch.float32 or t_max.shape != (n,):
        raise ValueError("t_max must be f32 [N]")
    on_device(active, dev, "active")
    on_device(t_max, dev, "t_max")
    return RayArgs(origin.contiguous(), direction.contiguous(),
                   active.contiguous(), t_max.contiguous())


def check_tables(tables, spec, what: str):
    """Raise unless every table ``(name, dtype, shape past dim 0)`` of
    ``spec`` has its dtype and shape."""
    for k, dtype, shape in spec:
        t = tables[k]
        if t.dtype != dtype or tuple(t.shape[1:]) != shape:
            raise ValueError(f"{what} table {k} must be {dtype} of shape "
                             f"[N, *{shape}], got {tuple(t.shape)} {t.dtype}")


def aligned_tables(tables, spec, device, what: str, align=None):
    """The tables of ``spec`` on ``device``, contiguous, each checked to
    start on a 16-byte boundary (the kernels read them as float4), or on
    the boundary ``align`` gives for its name."""
    out = []
    for k, _, _ in spec:
        t = on_device(tables[k].contiguous(), device, k)
        step = (align or {}).get(k, 16)
        if t.data_ptr() % step:
            raise ValueError(f"{what} table {k} must be {step}-byte "
                             "aligned")
        out.append(t)
    return out


def resources(entry: str, any_hit: bool) -> dict:
    """What the CUDA runtime reports of a persistent traversal kernel
    through its ``*_info`` entry: registers per thread, static shared
    bytes per block, local bytes per thread, resident blocks per SM,
    SMs."""
    out = (ctypes.c_int * 5)()
    rc = getattr(load(), entry)(int(any_hit), out)
    if rc:
        raise RuntimeError(f"{entry} failed with CUDA error {rc}")
    return dict(zip(("registers", "shared_bytes", "local_bytes",
                     "blocks_per_sm", "sms"), out))


def checked(t, dtype, shape, dev, what: str):
    """``t`` itself, after checking its dtype, shape, device and that it
    is contiguous."""
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} "
                         f"{list(shape)} on {dev}, got {tuple(t.shape)} "
                         f"{t.dtype} on {t.device}")
    return t


def on_device(t, device, name: str):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, rays are on {device}")
    return t


def hit_outputs(origin):
    """Kernel outputs (tri id i32, t, u, v), allocated by the caller."""
    n, dev = origin.shape[0], origin.device
    return (torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, device=dev), torch.empty(n, device=dev),
            torch.empty(n, device=dev))
