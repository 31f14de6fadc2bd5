"""Frozen copy of clive2_tpu_torch/ops/bsdf.py.

GGX microfacet BSDF suite with BDPT dual-pdf bookkeeping (port of
clive2_tpu/ops/bsdf.py).

Exact dielectric Fresnel, Smith GGX masking-shadowing, the GGX NDF,
half-vector Jacobians, the microfacet BRDF/BTDF, and the three bounce
routines that return both directional pdfs (c_p for the camera-direction
edge, l_p for the light-direction edge).  Elementwise over a leading batch
dim; directions point away from the surface vertex.
"""

from __future__ import annotations

import torch

from .. import constants
from .sampling import PI, dot, normalize, orthonormal, random_hemisphere_cosine


def specular_reflection(i, m):
    """Mirror i about m."""
    return normalize(2.0 * dot(i, m)[..., None] * m - i)


def ggx_transmit_direction(i, m, ni, no):
    """Snell refraction of i through microfacet m."""
    cos_i = dot(i, m)
    eta = ni / no
    cos_t = torch.sqrt(
        torch.clamp(1.0 + eta * eta * (cos_i * cos_i - 1.0), min=0.0))
    return normalize((eta * cos_i - cos_t)[..., None] * m - eta[..., None] * i)


def transmit_half_direction(i, o, ni, no):
    """Half vector of a refraction event."""
    return normalize(no[..., None] * o + ni[..., None] * i)


def fresnel(i, m, ni, nt):
    """Exact dielectric Fresnel; total internal reflection gives 1."""
    cos_i = dot(i, m).abs()
    eta = ni / nt
    sin_t2 = eta * eta * (1.0 - cos_i * cos_i)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    r_par = (nt * cos_i - ni * cos_t) / (nt * cos_i + ni * cos_t)
    r_perp = (ni * cos_i - nt * cos_t) / (ni * cos_i + nt * cos_t)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(sin_t2 >= 1.0, 1.0, f)


def ggx_g1(v, m, alpha):
    """Smith G1."""
    mv = dot(m, v)
    sin2 = 1.0 - mv * mv
    tan2 = sin2 / torch.clamp(mv * mv, min=1e-30)
    return 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))


def ggx_g(i, o, m, n, alpha):
    """Smith masking-shadowing with sidedness checks."""
    g = ggx_g1(i, m, alpha) * ggx_g1(o, m, alpha)
    ok = (dot(i, m) * dot(i, n) > 0.0) & (dot(o, m) * dot(o, n) > 0.0)
    return torch.where(ok, g, 0.0)


def ggx_d(m, n, alpha):
    """GGX NDF; alpha == 0 uses the delta convention D = 1."""
    a2 = alpha * alpha
    c = dot(m, n)
    denom = c * c * (a2 - 1.0) + 1.0
    d = a2 / (PI * denom * denom)
    return torch.where(alpha == 0.0, 1.0, d)


def reflect_jacobian(m, o):
    """d(omega_h)/d(omega_o) for reflection."""
    return 1.0 / (4.0 * dot(m, o).abs() + 1e-30)


def transmit_jacobian(i, o, ni, no):
    """d(omega_h)/d(omega_o) for refraction; the half vector is recomputed
    from (i, o, ni, no)."""
    h = transmit_half_direction(i, o, ni, no)
    cos_i = dot(i, h)
    cos_o = dot(o, h)
    num = no * no * cos_o.abs()
    den = (ni * cos_i + no * cos_o) ** 2
    return num / torch.clamp(den, min=1e-30)


def ggx_brdf_reflect(i, o, m, n, ni, no, alpha):
    """Microfacet reflection BRDF."""
    d = ggx_d(m, n, alpha)
    g = ggx_g(i, o, m, n, alpha)
    f = fresnel(i, m, ni, no)
    return (d * g * f) / (4.0 * dot(i, m).abs() + 1e-30)


def ggx_brdf_transmit(i, o, m, n, ni, no, alpha):
    """Microfacet transmission BTDF.  D, G and F are evaluated at the
    sampled microfacet normal ``m`` (the recomputed half vector ``h`` is
    anti-parallel to m and would trip G's sidedness check); ``h`` supplies
    the measure terms."""
    h = transmit_half_direction(i, o, ni, no)
    d = ggx_d(m, n, alpha)
    g = ggx_g(i, o, m, n, alpha)
    f = fresnel(i, m, ni, no)
    im = dot(i, h)
    om = dot(o, h)
    i_n = dot(i, n)
    o_n = dot(o, n)
    coeff = (im * om) / torch.where((i_n * o_n).abs() > 1e-30, i_n * o_n,
                                    1e-30)
    num = no * no * d * g * (1.0 - f)
    den = (ni * im + no * om) ** 2
    return coeff * num / torch.clamp(den, min=1e-30)


def interpolate_normal(n0, n1, n2, u, v):
    """Barycentric smooth shading normal."""
    w = (1.0 - u - v)[..., None]
    return normalize(n0 * w + n1 * u[..., None] + n2 * v[..., None])


# bounce routines: sample wo, return (wo, f, c_p, l_p) in camera convention

def diffuse_bounce(wi, n, rand):
    """Cosine-weighted Lambert bounce."""
    x, y = orthonormal(n)
    wo = random_hemisphere_cosine(x, y, n, rand)
    f = dot(n, wo).abs() / PI
    fwd = dot(n, wo).abs() / PI
    rev = dot(n, wi).abs() / PI
    return wo, f, fwd, rev


def reflect_bounce(wi, n, m, ni, no, alpha):
    """GGX reflection bounce."""
    wo = specular_reflection(wi, m)
    f = ggx_brdf_reflect(wi, wo, m, n, ni, no, alpha)
    pf = fresnel(wi, m, ni, no)
    pm = dot(m, n).abs() * ggx_d(m, n, alpha)
    fwd = pf * pm * reflect_jacobian(m, wo)
    rev = pf * pm * reflect_jacobian(m, wi)
    return wo, f, fwd, rev


def transmit_bounce(wi, n, m, ni, no, alpha):
    """GGX transmission bounce.  Under the corrected estimator f carries the
    |o.n| factor, so that f over the branch pdf equals Walter's weight; the
    reference estimator (``constants.REFERENCE_MIS``) leaves it out, as the
    reference does."""
    wo = ggx_transmit_direction(wi, m, ni, no)
    f = ggx_brdf_transmit(wi, wo, m, n, ni, no, alpha)
    if not constants.REFERENCE_MIS:
        f = f * dot(wo, n).abs()
    pf = 1.0 - fresnel(wi, m, ni, no)
    pm = dot(m, n).abs() * ggx_d(m, n, alpha)
    fwd = pf * pm * transmit_jacobian(wi, wo, ni, no)
    rev = pf * pm * transmit_jacobian(wo, wi, no, ni)
    return wo, f, fwd, rev
