"""ctypes binding to the native (C++) SAH BVH builder, csrc/bvh_builder.cpp.

The port compiles the repository's builder source into its own ignored
build directory (``clive2_tpu_torch/build/``) and never writes into
``csrc/``.  The library is keyed by a hash of the source, the compiler
flags and the host's CPU flags (it is built ``-march=native``, the flags of
``csrc/Makefile``, so its splits match the JAX package's library on the same
host).  When no C++ compiler is present the numpy builder in build.py runs
instead; both produce the same tree.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_SRC = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "csrc", "bvh_builder.cpp"))
BUILD_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "build"))
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_LIB = None
_TRIED = False


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def _build() -> str | None:
    """Compile the builder once per (source, flags, host); returns the
    library path, or None when the source or a compiler is missing."""
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
    except OSError:
        return None
    key = hashlib.sha256(
        src + " ".join(CXXFLAGS).encode() + _cpu_flags()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libclive2_bvh-{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC], timeout=120,
                       capture_output=True, check=True)
        os.replace(tmp, so)       # atomic: concurrent builders race safely
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.clive2_build_bvh.restype = ctypes.c_int64
    lib.clive2_build_bvh.argtypes = [
        ctypes.c_int64, f32, f32, ctypes.c_int64,
        f32, f32, i32, i32, i32, i32, i32, i32,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def build_bvh_native(soup, max_members: int):
    from .build import FlatBVH

    lib = _load()
    if lib is None:
        raise RuntimeError("native BVH builder is not available")
    n = len(soup)
    mins = np.ascontiguousarray(soup.mins, dtype=np.float32)
    maxes = np.ascontiguousarray(soup.maxes, dtype=np.float32)
    cap = max(2 * n, 8)
    node_mins = np.zeros((cap, 3), np.float32)
    node_maxes = np.zeros((cap, 3), np.float32)
    miss = np.zeros(cap, np.int32)
    right_child = np.zeros(cap, np.int32)
    tri_start = np.zeros(cap, np.int32)
    tri_count = np.zeros(cap, np.int32)
    leaf_id = np.zeros(cap, np.int32)
    permutation = np.zeros(max(n, 1), np.int32)

    n_nodes = int(lib.clive2_build_bvh(
        n, mins, maxes, max_members,
        node_mins, node_maxes, miss, right_child,
        tri_start, tri_count, leaf_id, permutation,
    ))
    if n_nodes <= 0:
        raise RuntimeError("native BVH build failed")
    return FlatBVH(
        node_mins=node_mins[:n_nodes].copy(),
        node_maxes=node_maxes[:n_nodes].copy(),
        miss=miss[:n_nodes].copy(),
        right_child=right_child[:n_nodes].copy(),
        tri_start=tri_start[:n_nodes].copy(),
        tri_count=tri_count[:n_nodes].copy(),
        leaf_id=leaf_id[:n_nodes].copy(),
        permutation=permutation.copy(),
        n_leaves=int((leaf_id[:n_nodes] >= 0).sum()),
        max_leaf_size=max_members,
    )
