"""Subpath generation: ray emission and depth-major wavefront tracing (port
of clive2_tpu/integrator/trace.py; both estimators, read at call time from
``constants.REFERENCE_MIS``).

At each depth the whole wavefront intersects the scene, shades and bounces
in lockstep, with dead rays masked; the JAX ``lax.scan`` over depth is a
Python loop here.  Paths are dicts of [D, N, ...] tensors.

BDPT bookkeeping (as in the JAX package):
  vertex k's c_importance = pdf of sampling edge (k-1 -> k) at vertex k-1
              walking from the camera
  vertex k's l_importance = pdf of sampling edge (k+1 -> k) at vertex k+1
              walking from the light
  tot_importance = running product of the forward importance
  color      = path throughput after the bounce at vertex k

Random numbers come from threefry keys folded per (purpose, depth), bit for
bit with the JAX package (``clive2_tpu_torch.rng``).

On the card each bounce's shading is one launch of csrc/shade.cu's kernel
(``shade_kernel``), which draws its own uniforms under the depth's keys;
its plain version, ``shade_plain`` (the same tensor code as the JAX
package's), runs on the CPU.  Both give the same bits.

``CLIVE2_TRACE_SORT`` in {auto, 0, 1} sets the Morton sort of the extension
casts (auto: ``intersect_scene``'s default, which sorts the streaming
tables' casts); it is read at call time.
"""

from __future__ import annotations

import os

import torch

from .. import constants, kernels, rng
from ..constants import DELTA, MAX_BOUNCES
from ..ops import bsdf
from ..ops.gather import gather_rows
from ..ops.intersect import cell_index, intersect_scene
from ..ops.sampling import (
    INV_2PI,
    dot,
    ggx_sample,
    normalize,
    orthonormal,
    random_hemisphere_uniform,
    sample_triangle_uniform,
)
from ..utils.profiling import count, span


def sort_knob(name):
    """A sort policy from the environment, read at call time: unset or
    "auto" -> None (``intersect_scene``'s default), "0" -> False, anything
    else -> True."""
    v = os.environ.get(name, "auto")
    return None if v in ("auto", "") else v != "0"


def _cells3(p, plo, phi, bits: int):
    """3D Morton code of ``p`` [N, 3] on a 2^bits grid over [plo, phi]
    (x major)."""
    q = cell_index((p - plo) / torch.clamp(phi - plo, min=1e-30)
                   * (1 << bits), 1 << bits)
    out = torch.zeros(p.shape[:-1], dtype=torch.int64, device=p.device)
    for b in range(bits):             # interleave x, y, z bit by bit
        for ax in range(3):
            out |= ((q[..., ax] >> b) & 1) << (3 * b + (2 - ax))
    return out


def light_gen_key(origin, direction, lo=None, hi=None):
    """Generation-time sort key of a light wavefront (port of the JAX
    package's, bit for bit): a coarse position Morton code (3 bits per
    axis, over the wavefront's own bounds ``lo``/``hi``: by default its
    origins' min and max) major, a direction Morton code (7 bits per axis)
    minor; 30 bits.  Light origins lie on the emitters, where the
    traversal's entry-point key collapses into one cell, so direction
    decides within an emitter and the position bits keep emitters apart.
    [N] int64."""
    lo = origin.amin(0) if lo is None else lo
    hi = origin.amax(0) if hi is None else hi
    pos = _cells3(origin, lo, hi, 3)
    unit = direction.new_tensor(1.0)
    return (pos << 21) | _cells3(direction, -unit, unit, 7)


def generate_camera_rays(key, cam, width: int, height: int, row0: int = 0,
                         rows: int = None, pixel_sel=None, lanes=None):
    """One jittered primary ray per pixel, raster order.  Rays start on the
    physical sensor plane and aim at the focal point.  ``row0``/``rows``
    restrict generation to an image stripe; ``pixel_sel`` ([M] int flat
    indices, may repeat) instead generates rays for a pixel subset.  Ray i
    takes its jitter from row i of the key's draw, or from row
    ``lanes[i]`` when ``lanes`` ([N] int) is given (a tile of a larger
    wavefront).  Returns (rays, pixel_idx [N] i32)."""
    dev = key.device
    if pixel_sel is not None:
        pixel_idx = pixel_sel.to(device=dev, dtype=torch.int32)
        n = pixel_idx.shape[0]
    else:
        n = width * (height if rows is None else rows)
        first = int(row0) * width
        pixel_idx = torch.arange(first, first + n, dtype=torch.int32,
                                 device=dev)
    off = rng.uniform(key, (n, 2), rows=lanes)

    px = (pixel_idx % width).to(torch.float32)
    py = (pixel_idx // width).to(torch.float32)
    xn = (px + off[:, 0] - 0.5 * width) / width
    yn = (py + off[:, 1] - 0.5 * height) / height

    origin = (
        cam["center"]
        + (xn * cam["phys_width"])[:, None] * cam["dx"]
        + (yn * cam["phys_height"])[:, None] * cam["dy"]
    )
    direction = normalize(cam["focal_point"] - origin)
    c_imp = 1.0 / (cam["phys_width"] * cam["phys_height"])

    rays = dict(
        origin=origin,
        direction=direction,
        normal=cam["direction"].expand(n, 3),
        color=torch.ones_like(origin),
        c_importance=c_imp.expand(n).clone(),
        l_importance=torch.ones(n, device=dev),    # filled during trace
        tot_importance=c_imp.expand(n).clone(),
        material=torch.full((n,), 7, dtype=torch.int32, device=dev),
        triangle=torch.full((n,), -1, dtype=torch.int32, device=dev),
        hit_light=torch.full((n,), -1, dtype=torch.int32, device=dev),
        hit_camera=torch.full((n,), -1, dtype=torch.int32, device=dev),
    )
    return rays, pixel_idx


def generate_light_rays(key, lights, materials, n: int, lanes=None):
    """``n`` uniform light-surface emission rays: a light triangle picked
    uniformly, a uniform point on it, a uniform-hemisphere direction;
    l_importance = 1/(count * area).  Ray i draws row i of each of the
    key's draws, or row ``lanes[i]`` when ``lanes`` ([n] int) is given."""
    dev = key.device
    k_pick, k_bary, k_dir = rng.split(key, 3)
    count = lights["v0"].shape[0]
    pick = torch.clamp(
        (rng.uniform(k_pick, (n,), rows=lanes) * count).to(torch.int32),
        max=count - 1)
    lv = {k: gather_rows(v, pick) for k, v in lights.items()}

    bary = rng.uniform(k_bary, (n, 2), rows=lanes)
    normal = lv["normal"]
    origin = sample_triangle_uniform(lv["v0"], lv["v1"], lv["v2"], bary)
    origin = origin + DELTA * normal

    x, y = orthonormal(normal)
    rolls = rng.uniform(k_dir, (n, 2), rows=lanes)
    direction = random_hemisphere_uniform(x, y, normal, rolls)

    l_imp = 1.0 / (count * lv["area"])
    emission = gather_rows(materials["emission"], lv["material"])

    return dict(
        origin=origin,
        direction=direction,
        normal=normal,
        color=emission,
        c_importance=torch.ones(n, device=dev),    # filled during trace
        l_importance=l_imp,
        tot_importance=l_imp,
        material=lv["material"].to(torch.int32),
        triangle=lv["tri_index"].to(torch.int32),
        hit_light=torch.full((n,), -1, dtype=torch.int32, device=dev),
        hit_camera=torch.full((n,), -1, dtype=torch.int32, device=dev),
    )


def _select_bounce(mat_type, f_lottery, fres, diffuse, reflect, transmit):
    """Material dispatch as masked selects.  type 0: diffuse; 1:
    Fresnel-weighted reflect|transmit; 2: Fresnel-weighted reflect|diffuse;
    else: reflect."""
    take_reflect = f_lottery <= fres
    picks = []
    for branch in range(4):  # wo, f, c_p, l_p
        d, r, t = diffuse[branch], reflect[branch], transmit[branch]
        expand = (lambda c: c[:, None]) if branch == 0 else (lambda c: c)
        picks.append(torch.where(
            expand(mat_type == 0),
            d,
            torch.where(
                expand(mat_type == 1),
                torch.where(expand(take_reflect), r, t),
                torch.where(
                    expand(mat_type == 2),
                    torch.where(expand(take_reflect), r, d),
                    r,
                ),
            ),
        ))
    return tuple(picks)


def trace_subpaths(key, rays, scene, from_camera,
                   max_bounces: int = MAX_BOUNCES, lanes=None, sort=None):
    """Trace a wavefront of subpaths to ``max_bounces`` stored vertices.

    ``from_camera`` is a bool or a per-ray [N] bool tensor, so camera and
    light wavefronts trace as one merged wavefront.  Ray i draws row i of
    each depth's random numbers, or row ``lanes[i]`` when ``lanes`` ([N]
    int) is given.  ``sort`` is the extension casts' Morton-sort policy
    (``intersect_scene``); None reads ``CLIVE2_TRACE_SORT``.  Each
    bounce's shading, from the hit's gathers to the next ray, runs in the
    span ``trace.shade``: on CUDA tensors one launch of
    ``clive2_trace_shade`` (``shade_kernel``), on CPU tensors the plain
    version (``shade_plain``).  While a profiler records, the stored
    vertices and those among them on a specular material are counted
    (``trace.vertices``, ``trace.specular_vertices``;
    ``utils/profiling.py:count``).  Returns
      vertices: dict of [D, N, ...] tensors (fields as in generate_*)
      valid:    [D, N] bool, vertex d stored
      length:   [N] i32
      n_rays:   extension rays cast (one per stored vertex plus the final
                breaking cast, capped at max_bounces)
    """
    cast_sort = sort_knob("CLIVE2_TRACE_SORT") if sort is None else sort
    dev = rays["origin"].device
    shade = shade_plain if dev.type == "cpu" else shade_kernel

    n = rays["origin"].shape[0]
    fc = torch.as_tensor(from_camera, device=dev).to(torch.bool).expand(n)
    fwd_pending = torch.where(fc, rays["c_importance"], INV_2PI)
    if lanes is not None:
        lanes = lanes.to(device=dev, dtype=torch.int64).contiguous()

    cur = {k: v.contiguous() for k, v in rays.items()}
    active = torch.ones(n, dtype=torch.bool, device=dev)
    vertices = {k: torch.empty((max_bounces,) + tuple(v.shape),
                               dtype=v.dtype, device=dev)
                for k, v in cur.items()}
    valid = torch.empty((max_bounces, n), dtype=torch.bool, device=dev)
    for depth in range(max_bounces):
        hit = intersect_scene(cur["origin"], cur["direction"], scene,
                              active=active, sort=cast_sort)
        keys = rng.split(rng.fold_in(key, depth), 3)
        with span("trace.shade"):
            cur, active, fwd_pending = shade(
                keys, depth, hit, cur, active, fwd_pending, fc, lanes,
                scene, vertices, valid)

    mat = scene["mat"]
    count("trace.vertices", lambda: valid.sum())
    count("trace.specular_vertices",
          lambda: (valid & specular(vertices, mat)).sum())
    length = valid.to(torch.int32).sum(0, dtype=torch.int32)
    n_rays = torch.clamp(length + 1, max=max_bounces).sum()
    return dict(vertices=vertices, valid=valid, length=length, n_rays=n_rays)


def shade_plain(keys, depth, hit, cur, active, fwd_pending, fc, lanes,
                scene, vertices, stored):
    """One bounce of ``trace_subpaths`` as tensor ops, on any device: the
    hit's gathers, the bounce drawn under ``keys`` ([3, 2]: the depth's
    keys of roll_a, roll_b and roll_c; rows ``lanes`` of each draw when
    given), every bounce routine and ``_select_bounce``, the throughput,
    the pdfs and the store and continue rules, under the estimator that
    ``constants.REFERENCE_MIS`` names at this call.  Writes vertex
    ``depth`` into ``vertices`` and ``stored`` ([D, N] bool); returns the next rays,
    active lanes and pending forward pdfs (dead lanes frozen)."""
    shade_plain.calls += 1
    reference = constants.REFERENCE_MIS
    tri = scene["tri"]
    mat = scene["mat"]
    n = cur["origin"].shape[0]
    hit_i, hit_t, hit_u, hit_v = hit
    hit_ok = hit_i >= 0
    safe_i = torch.clamp(hit_i, min=0)

    attrs = gather_rows(tri["packed"], safe_i)
    face_n = attrs[:, 0:3]
    n0 = attrs[:, 3:6]
    n1 = attrs[:, 6:9]
    n2 = attrs[:, 9:12]
    tri_mat = attrs[:, 12].to(torch.int32)
    is_light = attrs[:, 13].to(torch.int32)
    is_camera = attrs[:, 14].to(torch.int32)

    alpha = gather_rows(mat["alpha"], tri_mat)
    ior = gather_rows(mat["ior"], tri_mat)
    mat_type = gather_rows(mat["type"], tri_mat)
    mat_color = gather_rows(mat["color"], tri_mat)

    d = cur["direction"]
    cos_f = dot(-d, face_n)
    front = cos_f > 0.0
    degenerate = cos_f == 0.0

    sampled_n = bsdf.interpolate_normal(n0, n1, n2, hit_u, hit_v)
    nrm = torch.where(front[:, None], sampled_n, -sampled_n)
    ni = torch.where(front, 1.0, ior)
    no = torch.where(front, ior, 1.0)

    new_origin = cur["origin"] + d * hit_t[:, None]
    new_hit_light = torch.where(
        (is_light != 0) & (dot(d, face_n) < 0.0), hit_i, -1)
    new_hit_camera = torch.where(is_camera != 0, hit_i, -1)

    wi = -d
    ka, kb, kc = keys
    roll_a = rng.uniform(ka, (n, 2), rows=lanes)
    roll_b = rng.uniform(kb, (n, 2), rows=lanes)
    # an independent uniform for the Fresnel lottery (the reference reuses
    # roll_b.x)
    roll_c = rng.uniform(kc, (n,), rows=lanes)

    m = ggx_sample(nrm, roll_a, alpha)
    ok_m = (dot(wi, m) >= 0.0) & (dot(m, nrm) >= 0.0)
    fres = bsdf.fresnel(wi, m, ni, no)

    # bounce routines return (fwd, rev) pdfs in camera convention; swap per
    # ray for light-subpath lanes
    diffuse = bsdf.diffuse_bounce(wi, nrm, roll_b)
    reflect = bsdf.reflect_bounce(wi, nrm, m, ni, no, alpha)
    transmit = bsdf.transmit_bounce(wi, nrm, m, ni, no, alpha)
    wo, f, fwd_p, rev_p = _select_bounce(
        mat_type, roll_c, fres, diffuse, reflect, transmit)
    c_p = torch.where(fc, fwd_p, rev_p)
    l_p = torch.where(fc, rev_p, fwd_p)

    # throughput: material color only on external reflection / egress
    wi_fn = dot(wi, face_n)
    wo_fn = dot(wo, face_n)
    apply_color = (((wi_fn > 0.0) & (wo_fn > 0.0))
                   | ((wi_fn < 0.0) & (wo_fn > 0.0)))
    new_color = torch.where(
        apply_color[:, None],
        f[:, None] * cur["color"] * mat_color,
        f[:, None] * cur["color"],
    )
    # the Lambertian emitter's flux toward the first light-subpath edge
    # carries cos(n_light, dir): fold it in at the first light bounce (the
    # reference estimator omits it)
    if depth == 0 and not reference:
        emit_cos = dot(cur["direction"], cur["normal"]).abs()
        new_color = torch.where(
            (~fc)[:, None], new_color * emit_cos[:, None], new_color)

    new_fwd = fwd_pending
    new_tot = cur["tot_importance"] * new_fwd

    bounce_ok = ok_m & (f != 0.0)
    if reference:
        # the reference stores a vertex only when the bounce at the next
        # hit also succeeded (its reverse pdf comes from that bounce)
        valid = active & hit_ok & ~degenerate & bounce_ok
        store = valid
    else:
        # store on hit success alone; continue only if the bounce succeeded
        store = active & hit_ok & ~degenerate
        valid = store & bounce_ok

    emit = dict(cur)
    emit["l_importance"] = torch.where(fc, l_p, cur["l_importance"])
    emit["c_importance"] = torch.where(fc, cur["c_importance"], c_p)
    next_pending = torch.where(fc, c_p, l_p)

    new_cur = dict(
        origin=new_origin,
        direction=wo,
        normal=nrm,
        color=new_color,
        c_importance=torch.where(fc, new_fwd, 1.0),
        l_importance=torch.where(fc, 1.0, new_fwd),
        tot_importance=new_tot,
        material=tri_mat,
        triangle=hit_i.to(torch.int32),
        hit_light=new_hit_light.to(torch.int32),
        hit_camera=new_hit_camera.to(torch.int32),
    )
    # dead lanes stay frozen (masked by `valid` downstream)
    cur = {
        k: torch.where(valid.reshape((n,) + (1,) * (v.dim() - 1)), v,
                       cur[k])
        for k, v in new_cur.items()
    }
    fwd_pending = torch.where(valid, next_pending, fwd_pending)
    for k, v in emit.items():
        vertices[k][depth] = v
    stored[depth] = store
    return cur, valid, fwd_pending


shade_plain.calls = 0


# ---- the kernel's wrapper (csrc/shade.cu) ------------------------------------

# a wavefront's ray fields, in the order of clive2_trace_shade's arguments
RAY_FIELDS = ("origin", "direction", "normal", "color", "c_importance",
              "l_importance", "tot_importance", "material", "triangle",
              "hit_light", "hit_camera")


def _ray_field(k: str, n: int):
    """(dtype, shape) of ray field ``k`` of ``n`` lanes."""
    return (torch.int32 if k in RAY_FIELDS[7:] else torch.float32,
            (n, 3) if k in RAY_FIELDS[:4] else (n,))


def shade_kernel(keys, depth, hit, cur, active, fwd_pending, fc, lanes,
                 scene, vertices, stored):
    """``shade_plain`` through ``clive2_trace_shade``, on the device of the
    rays' tensors, under the estimator ``constants.REFERENCE_MIS`` names at
    this call: one launch, no host read of a device value.  ``active`` and
    ``fwd_pending`` are written in place, and returned; the next rays go
    into ``cur``'s own tensors past depth 0, into new ones at depth 0, so
    the caller's rays are never written.  ``fc`` is [N] bool, contiguous or
    one value expanded; ``lanes`` None or contiguous int64 [N].  Any depth
    the subpaths store (the glass furnace traces 12).  Raises on an input
    the kernel does not take."""
    dev, n = cur["origin"].device, cur["origin"].shape[0]
    d_max = stored.shape[0]
    if not 0 <= depth < d_max:
        raise ValueError(f"depth {depth}: the subpaths store {d_max} "
                         "vertices")
    if set(cur) != set(RAY_FIELDS) or set(vertices) != set(RAY_FIELDS):
        raise ValueError(f"the rays and vertices hold the fields "
                         f"{RAY_FIELDS}, got {sorted(cur)}, "
                         f"{sorted(vertices)}")
    for k in RAY_FIELDS:
        dtype, shape = _ray_field(k, n)
        kernels.checked(cur[k], dtype, shape, dev, f"ray {k}")
        kernels.checked(vertices[k], dtype, (d_max,) + shape, dev,
                        f"vertex {k}")
    kernels.checked(stored, torch.bool, (d_max, n), dev, "stored")
    hit = [kernels.checked(h, torch.int32 if j == 0 else torch.float32,
                           (n,), dev, f"hit {what}")
           for j, (h, what) in enumerate(zip(hit, "ituv"))]
    kernels.checked(active, torch.bool, (n,), dev, "active")
    kernels.checked(fwd_pending, torch.float32, (n,), dev, "pending pdfs")
    if (fc.dtype != torch.bool or tuple(fc.shape) != (n,)
            or fc.device != dev or fc.stride(0) not in (0, 1)):
        raise ValueError(f"from_camera must be bool [{n}] on {dev}, "
                         "contiguous or one value expanded, got "
                         f"{tuple(fc.shape)} {fc.dtype} {fc.stride()} on "
                         f"{fc.device}")
    kernels.checked(keys, torch.int64, (3, 2), dev, "keys")
    if lanes is not None:
        kernels.checked(lanes, torch.int64, (n,), dev, "lanes")
    packed, mat = scene["tri"]["packed"], scene["mat"]
    if (packed.dtype != torch.float32 or packed.dim() != 2
            or packed.shape[1] < 15 or packed.stride(1) != 1
            or packed.device != dev):
        raise ValueError("scene tri packed must be f32 [T, >= 15] rows on "
                         f"{dev}")
    m = mat["type"].shape[0]
    tables = [kernels.checked(mat[k], dtype, shape, dev, f"material {k}")
              for k, dtype, shape in (
                  ("alpha", torch.float32, (m,)),
                  ("ior", torch.float32, (m,)),
                  ("type", torch.int32, (m,)),
                  ("color", torch.float32, (m, 3)))]
    nxt = cur if depth else {k: torch.empty_like(v) for k, v in cur.items()}
    if n:
        kernels.call(
            "clive2_trace_shade", dev,
            *(cur[k].data_ptr() for k in RAY_FIELDS),
            *(nxt[k].data_ptr() for k in RAY_FIELDS),
            *(vertices[k][depth].data_ptr() for k in RAY_FIELDS),
            *(h.data_ptr() for h in hit), active.data_ptr(),
            fwd_pending.data_ptr(), stored[depth].data_ptr(),
            fc.data_ptr(), fc.stride(0), keys.data_ptr(),
            None if lanes is None else lanes.data_ptr(), n, depth,
            packed.data_ptr(), packed.stride(0), packed.shape[0],
            *(t.data_ptr() for t in tables), m,
            int(constants.REFERENCE_MIS))
        shade_kernel.launches += 1
    return nxt, active, fwd_pending


shade_kernel.launches = 0


def specular(V, mat):
    """[D, N] bool: the subpath vertices ``V`` lie on specular materials
    (type above 0; ``csrc/connect.cu:specular``)."""
    matv = V["material"]
    return gather_rows(mat["type"], matv.reshape(-1)).reshape(matv.shape) > 0


def unidirectional_image(path, all_hits: bool = False):
    """Plain path-traced estimate from a camera path: the first stored
    vertex that hit a light contributes prior color / tot_importance.

    ``all_hits=True`` sums EVERY stored light-hit vertex instead, so that
    transport through vertices on an emitter counts too: the integral the
    BDPT strategies target, which the convergence oracles compare against.
    """
    hit_light = path["vertices"]["hit_light"]   # [D, N]
    mask = path["valid"] & (hit_light >= 0)
    color = path["vertices"]["color"]           # [D, N, 3]
    tot = path["vertices"]["tot_importance"]    # [D, N]
    if all_hits:
        # the prior vertex's throughput; vertex 0 is never a light hit
        prior = torch.cat([torch.ones_like(color[:1]), color[:-1]])
        est = prior / torch.clamp(tot, min=1e-30)[:, :, None]
        return torch.where(mask[:, :, None], est, 0.0).sum(0)
    has = mask.any(0)
    first = torch.argmax(mask.to(torch.int32), dim=0)  # first True
    prior_color = color.gather(
        0, torch.clamp(first - 1, min=0)[None, :, None].expand(1, -1, 3))[0]
    tot_first = tot.gather(0, first[None, :])[0]
    out = prior_color / torch.clamp(tot_first, min=1e-30)[:, None]
    return torch.where(has[:, None], out, 0.0)
