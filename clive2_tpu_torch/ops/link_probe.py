"""The link probe's kernel: o = a * 2 + 1 on an f32 tensor.

Replaces the TPU kernel ``scripts/link_probe.py:probe.k`` (``pallas_call``
at :88), whose first and steady runs are the probe's last two phases
(scripts/link_probe.py in this package times them).  The kernel is
csrc/link_probe.cu; ``scale_shift_plain`` is its plain version.
"""

from __future__ import annotations

import ctypes

import torch


def scale_shift_plain(a):
    """The probe kernel's plain version: a * 2 + 1."""
    scale_shift_plain.calls += 1
    return a * 2.0 + 1.0


scale_shift_plain.calls = 0


def scale_shift(a):
    """a * 2 + 1 on an f32 tensor: the kernel (csrc/link_probe.cu) on a
    CUDA tensor, the plain version on a CPU tensor."""
    if a.device.type == "cpu":
        return scale_shift_plain(a)
    from .. import kernels

    if a.device.type != "cuda" or a.dtype != torch.float32:
        raise ValueError(f"the probe kernel takes f32 CUDA tensors, got "
                         f"{a.dtype} on {a.device}")
    a = a.contiguous()
    o = torch.empty_like(a)
    if a.numel():
        kernels.call("clive2_link_probe", a.device, kernels.ptr(a),
                     kernels.ptr(o), ctypes.c_int64(a.numel()))
        scale_shift.launches += 1
    return o


scale_shift.launches = 0
