"""Frozen copy of clive2_tpu_torch/ops/gather.py.

Row gathers (port of clive2_tpu/ops/gather.py).

The JAX package gathers rows of small tables through a one-hot matmul (a
TPU workaround); here a gather is plain indexing.  The one-hot path's
semantics are kept: an index outside [0, T) gives a zero row instead of
raising (PyTorch would raise on the CPU and assert on the card).
"""

from __future__ import annotations

import torch


def gather_rows(table, idx):
    """table [T, ...] gathered at idx [N] -> [N, ...]; out-of-range -> 0."""
    t = table.shape[0]
    ok = (idx >= 0) & (idx < t)
    out = table[idx.clamp(0, t - 1)]
    return torch.where(ok.reshape(ok.shape + (1,) * (out.dim() - 1)), out,
                       torch.zeros((), dtype=out.dtype, device=out.device))
