"""The link probe's kernel: o = a * 2 + 1 on an f32 tensor.

Replaces the TPU kernel ``scripts/link_probe.py:probe.k`` (``pallas_call``
at :88), whose first and steady runs are the probe's last two phases
(scripts/link_probe.py in this package times them).  The kernel is
csrc/link_probe.cu; ``scale_shift_plain`` is its plain version.
"""

from __future__ import annotations

import torch

from .. import kernels


def scale_shift_plain(a):
    """The probe kernel's plain version: a * 2 + 1."""
    scale_shift_plain.calls += 1
    return a * 2.0 + 1.0


scale_shift_plain.calls = 0


def scale_shift(a):
    """a * 2 + 1 on an f32 tensor: the kernel (csrc/link_probe.cu) on a
    CUDA tensor, the plain version on a CPU tensor.  Its host path is a
    launch's whole cost at the probe's size, so it checks the device once
    and reads each figure once."""
    if not a.is_cuda or a.dtype != torch.float32:
        if a.device.type == "cpu":
            return scale_shift_plain(a)
        raise ValueError(f"the probe kernel takes f32 CUDA tensors, got "
                         f"{a.dtype} on {a.device}")
    a = a.contiguous()
    o = torch.empty_like(a)
    n = a.numel()
    if n:
        kernels.call("clive2_link_probe", a.device, a.data_ptr(),
                     o.data_ptr(), n)
        scale_shift.launches += 1
    return o


scale_shift.launches = 0
