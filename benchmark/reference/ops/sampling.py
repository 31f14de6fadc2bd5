"""Frozen copy of clive2_tpu_torch/ops/sampling.py.

Batched direction sampling ops (port of clive2_tpu/ops/sampling.py).

Elementwise torch with the JAX package's expression order, so CPU results
match it to float rounding.  Vectors are [..., 3] float32; every function is
vectorised over the leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PI = float(np.float32(np.pi))
# 1/pi and 1/(2 pi) rounded once in float32, as the JAX package computes them
INV_PI = float(np.float32(1.0) / np.float32(PI))
INV_2PI = float(np.float32(1.0) / (np.float32(2.0) * np.float32(PI)))


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    """a x b with jnp.cross's component order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def normalize(v, eps: float = 0.0):
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.clamp(n, min=1e-30 if eps == 0.0 else eps)


def orthonormal(n):
    """Tangent frame (x, y) for unit normal n: the cardinal axis with the
    smallest |n| component, projected orthogonal to n."""
    axis = torch.argmin(n.abs(), dim=-1)
    v = F.one_hot(axis, 3).to(n.dtype)
    x = normalize(v - dot(v, n)[..., None] * n)
    y = normalize(cross(n, x))
    return x, y


def random_hemisphere_cosine(x_axis, y_axis, z_axis, rand):
    """Cosine-weighted hemisphere direction; rand [..., 2] uniforms."""
    theta = torch.arccos(torch.sqrt(rand[..., 0]))
    phi = 2.0 * PI * rand[..., 1]
    st, ct = torch.sin(theta), torch.cos(theta)
    d = (
        (st * torch.cos(phi))[..., None] * x_axis
        + (st * torch.sin(phi))[..., None] * y_axis
        + ct[..., None] * z_axis
    )
    return normalize(d)


def random_hemisphere_uniform(x_axis, y_axis, z_axis, rand):
    """Uniform hemisphere direction."""
    z = rand[..., 0]
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * PI * rand[..., 1]
    d = (
        (r * torch.cos(phi))[..., None] * x_axis
        + (r * torch.sin(phi))[..., None] * y_axis
        + z[..., None] * z_axis
    )
    return normalize(d)


def ggx_sample(n, rand, alpha):
    """GGX microfacet half-vector around normal n; alpha [...] or scalar."""
    x, y = orthonormal(n)
    theta = 2.0 * PI * rand[..., 0]
    r2 = rand[..., 1]
    phi = torch.arctan(
        alpha * torch.sqrt(r2) / torch.sqrt(torch.clamp(1.0 - r2, min=1e-30)))
    sp, cp = torch.sin(phi), torch.cos(phi)
    m = (
        (sp * torch.cos(theta))[..., None] * x
        + (sp * torch.sin(theta))[..., None] * y
        + cp[..., None] * n
    )
    return normalize(m)


def sample_triangle_uniform(v0, v1, v2, rand):
    """Uniform point on a triangle: P = u*v0 + v*v1 + w*v2 with (u, v)
    folded into the unit triangle and w = 1-u-v."""
    u = rand[..., 0]
    v = rand[..., 1]
    flip = (u + v) > 1.0
    u = torch.where(flip, 1.0 - u, u)
    v = torch.where(flip, 1.0 - v, v)
    w = 1.0 - u - v
    return u[..., None] * v0 + v[..., None] * v1 + w[..., None] * v2
