"""BDPT vertex connection with balance-heuristic MIS (port of
clive2_tpu/integrator/connect.py; both estimators, read at call time from
``constants.REFERENCE_MIS``).

Stage A casts every (t, s) strategy that needs a ray (t=1 camera-plane
projections and general-join visibility tests) as ONE batch of P*N rays:
any-hit casts capped below the target under the corrected estimator,
closest-hit casts capped just beyond it under the reference estimator (whose
visibility rule asks that the hit BE the target).  Stage B weighs and sums
every strategy from the cast's answers; t=1 splats are added into the light
image, splat pixels outside the image dropped.

On the card each stage is one hand-written kernel (csrc/connect.cu):
``clive2_connect_rays`` writes stage A's rays (``rays_kernel``) and
``clive2_connect_shade`` weighs every strategy of a lane in registers and
adds its splats with atomics (``shade_kernel``).  Their plain versions,
``connection_rays_plain`` and ``shade_plain`` (the per-strategy MIS chains
unrolled as masked elementwise ops over the wavefront, the splats one
scatter-add per image), run on the CPU, and on any device for
``connect_paths(debug_per_strategy=True)``.

The JAX package's A/B knobs of that cast, read from the environment at call
time:
  CLIVE2_ANY_HIT=0       closest-hit casts capped just beyond the target
                         under the corrected estimator too;
  CLIVE2_CONNECT_SORT    {auto, 0, 1}: the cast's Morton sort
                         (``intersect_scene``; auto sorts the streaming
                         tables' casts);
  CLIVE2_CONNECT_K=K     a compacted [K, N] cast of each pixel's first K
                         active strategies, the rest in a second, full cast
                         that runs only when some pixel has more (0: off).
Each casts the same rays with the same caps, so per ray the results are
the same.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from .. import constants, kernels
from ..constants import DELTA, MAX_BOUNCES
from ..materials import CAMERA_MATERIAL
from ..ops.gather import gather_rows
from ..ops.intersect import intersect_scene
from ..ops.sampling import INV_2PI, INV_PI, PI, dot, normalize
from ..utils.profiling import spanned
from .trace import sort_knob, specular


def any_hit_casts() -> bool:
    """False under ``CLIVE2_ANY_HIT=0``."""
    return os.environ.get("CLIVE2_ANY_HIT", "1") != "0"


def connect_k() -> int:
    """``CLIVE2_CONNECT_K`` (0, the default, casts the full batch)."""
    return int(os.environ.get("CLIVE2_CONNECT_K", "0"))


def _vstatic(tree, d: int):
    return {k: v[d] for k, v in tree.items()}


def _geom(a, b):
    """The reference's cosine_geometry_term: each vertex's cosine against
    its own STORED direction, over the squared distance."""
    delta = b["origin"] - a["origin"]
    dist2 = torch.clamp(dot(delta, delta), min=1e-30)
    cos_a = dot(a["direction"], a["normal"]).abs()
    cos_b = dot(b["direction"], b["normal"]).abs()
    return cos_a * cos_b / dist2


def connection_pairs(max_bounces: int = MAX_BOUNCES):
    """(t, s) strategies that require a ray cast, in cast order."""
    return [(t, s) for t in range(1, max_bounces + 1)
            for s in range(1, max_bounces + 1) if t + s >= 2]


def _splat_image(pix, vals, width: int, height: int):
    """Scatter-add one t=1 strategy's [M, ...] debug values onto a flat W*H
    image at pixels ``pix``; pixels at W*H (dropped splats) are left out."""
    keep = pix < width * height
    out = vals.new_zeros((width * height,) + vals.shape[1:])
    out.index_add_(0, pix[keep].long(), vals[keep])
    return out


def _compacted_cast(origin, direction, active, t_max, scene, k: int,
                    sort, any_hit):
    """Stage A's cast of [P, N] rays through a [K, N] cast of each lane's
    first ``k`` active pairs, the pairs past them through a full cast that
    runs only when there are any.  Returns (tri [P, N], t [P, N])."""
    p_cnt, n = active.shape
    dev = active.device
    act_i = active.to(torch.int32)
    rank = torch.cumsum(act_i, 0) - act_i
    score = torch.where(active, p_cnt - torch.arange(
        p_cnt, dtype=torch.int32, device=dev)[:, None], 0)
    # active pairs score distinct values, so ties (which lax.top_k and
    # torch.topk may break differently) fall only among dead pairs, and
    # those are dropped
    vals, idxs = torch.topk(score.T, k, dim=1)            # [N, K]
    sel = idxs.T                                          # [K, N] pair ids
    act_k = (vals > 0).T
    flat = lambda a: a.reshape((k * n,) + a.shape[2:])
    pick = lambda a: a.gather(0, sel.reshape(sel.shape + (1,) * (
        a.dim() - 2)).expand((k,) + a.shape[1:]))
    hi_k, ht_k, _, _ = intersect_scene(
        flat(pick(origin)), flat(pick(direction)), scene,
        active=flat(act_k), t_max=flat(pick(t_max)), any_hit=any_hit,
        sort=sort)
    pix = torch.arange(n, device=dev).expand(k, n)
    row = torch.where(act_k, sel, p_cnt)                  # dead -> dropped
    cast_tri = torch.full((p_cnt + 1, n), -1, dtype=torch.int32, device=dev)
    cast_t = torch.full((p_cnt + 1, n), float("inf"), device=dev)
    cast_tri[row, pix] = hi_k.reshape(k, n)
    cast_t[row, pix] = ht_k.reshape(k, n)
    cast_tri, cast_t = cast_tri[:p_cnt], cast_t[:p_cnt]
    rem = active & (rank >= k)
    if rem.any():
        hi_r, ht_r, _, _ = intersect_scene(
            origin.reshape(p_cnt * n, 3), direction.reshape(p_cnt * n, 3),
            scene, active=rem.reshape(-1), t_max=t_max.reshape(-1),
            any_hit=any_hit, sort=sort)
        cast_tri = torch.where(rem, hi_r.reshape(p_cnt, n), cast_tri)
        cast_t = torch.where(rem, ht_r.reshape(p_cnt, n), cast_t)
    return cast_tri, cast_t


def connection_rays(cam_path, light_path, scene, pairs, l_spec, c_spec,
                    any_hit: bool):
    """Stage A's rays, [P, N, ...] for the (t, s) strategies of ``pairs``:
    from light vertex s-1 towards camera vertex t-1 (t=1: towards the
    focal point), active where the strategy needs its cast, capped at the
    target (camera vertex or sensor plane): below it for any-hit casts,
    just beyond it for closest-hit ones.  ``l_spec``/``c_spec``: [D, N]
    specular flags of the light and camera subpaths' vertices
    (``specular``), or None to derive them from the scene's materials.
    Returns (origin, direction, active, t_max).

    On CUDA tensors the kernel ``clive2_connect_rays`` (``rays_kernel``)
    computes them, deriving the specular flags itself (so ``l_spec`` and
    ``c_spec`` are not read there); on CPU tensors the plain version."""
    if cam_path["length"].device.type == "cpu":
        return connection_rays_plain(cam_path, light_path, scene, pairs,
                                     l_spec, c_spec, any_hit)
    return rays_kernel(cam_path, light_path, scene, pairs, any_hit)


def connection_rays_plain(cam_path, light_path, scene, pairs, l_spec,
                          c_spec, any_hit: bool):
    """``connection_rays`` as tensor ops, on any device."""
    connection_rays_plain.calls += 1
    CV, cam_len = cam_path["vertices"], cam_path["length"]
    LV, light_len = light_path["vertices"], light_path["length"]
    cam = scene["camera"]
    if l_spec is None:
        l_spec = specular(LV, scene["mat"])
    if c_spec is None:
        c_spec = specular(CV, scene["mat"])
    pair_arr = torch.tensor(pairs, dtype=torch.int32, device=cam_len.device)
    t_i = (pair_arr[:, 0] - 1).long()             # [P]
    s_i = (pair_arr[:, 1] - 1).long()
    lv_o = LV["origin"][s_i]                      # [P, N, 3]
    lv_n = LV["normal"][s_i]
    cv_o = CV["origin"][t_i]
    cv_n = CV["normal"][t_i]
    l_spec = l_spec[s_i]                          # [P, N]
    c_spec = c_spec[t_i]

    t_col = pair_arr[:, 0][:, None]               # [P, 1]
    s_col = pair_arr[:, 1][:, None]
    lens_ok = (t_col <= cam_len[None, :]) & (s_col <= light_len[None, :])

    proj_dir = normalize(cam["focal_point"] - lv_o)
    cam_dir = cam["direction"]
    t1_ok = ~l_spec & (dot(proj_dir, cam_dir) <= 0.0)

    dir_l_to_c = normalize(cv_o - lv_o)
    gen_ok = (
        ~l_spec
        & ~c_spec
        & (dot(lv_n, dir_l_to_c) >= DELTA)
        & (dot(cv_n, -dir_l_to_c) >= DELTA)
    )
    del lv_n, cv_n, l_spec, c_spec

    is_t1 = (pair_arr[:, 0] == 1)[:, None]        # [P, 1]
    active = lens_ok & torch.where(is_t1, t1_ok, gen_ok)
    direction = torch.where(is_t1[..., None], proj_dir, dir_l_to_c)
    del lens_ok, t1_ok, gen_ok, dir_l_to_c
    # per-ray caps at the target (a general join's camera vertex, a t=1
    # projection's sensor plane)
    delta_pc = cv_o - lv_o
    d_gen = torch.sqrt(torch.clamp(dot(delta_pc, delta_pc), min=0.0))
    den = dot(proj_dir, cam_dir)
    num = dot(cam["center"] - lv_o, cam_dir)
    d_t1 = torch.where(den < -1e-12, num / den, float("inf"))
    if not any_hit:
        # closest-hit visibility (the hit must BE the target): cap just
        # beyond the target so that it registers
        t_max = torch.where(is_t1, d_t1, d_gen) * 1.001 + 1e-4
    else:
        # strictly below the target: every recordable hit is a true
        # occluder, so the cast may stop at the first one (any_hit)
        t_max = torch.where(is_t1, d_t1, d_gen) * (1.0 - 1e-3)
    del cv_o, proj_dir, delta_pc, d_gen, den, num, d_t1

    return lv_o, direction, active, t_max


connection_rays_plain.calls = 0


# ---- the kernels' wrappers (csrc/connect.cu) --------------------------------

_VEC_FIELDS = ("origin", "direction", "normal", "color")
_INT_FIELDS = ("material", "triangle", "hit_light")
_RAY_FIELDS = ("origin", "normal", "material")
_SHADE_FIELDS = ("origin", "direction", "normal", "color", "c_importance",
                 "l_importance", "tot_importance", "material", "triangle")


def _path_fields(path, fields, n: int, dev, what: str):
    """Pointers of a subpath's vertex ``fields`` ([D, N, 3] f32 vectors,
    [D, N] f32 or i32 scalars, each depth row contiguous and every field
    ``stride`` lanes from one depth to the next), with the stride and D.
    Raises on a field the kernels do not take."""
    ptrs, stride, depth = [], None, None
    for k in fields:
        v = path["vertices"][k]
        vec = k in _VEC_FIELDS
        dtype = torch.int32 if k in _INT_FIELDS else torch.float32
        shape = (v.shape[0], n, 3) if vec else (v.shape[0], n)
        if v.device != dev or v.dtype != dtype or tuple(v.shape) != shape:
            raise ValueError(
                f"{what} field {k} must be {dtype} [D, {n}"
                f"{', 3' if vec else ''}] on {dev}, got {tuple(v.shape)} "
                f"{v.dtype} on {v.device}")
        inner = (3, 1) if vec else (1,)
        width = 3 if vec else 1
        rows = all(st == want or size == 1 for st, want, size in
                   zip(v.stride()[1:], inner, v.shape[1:]))
        step = v.stride(0)
        if (not rows or step % width
                or (v.shape[0] > 1 and stride is not None
                    and step // width != stride)):
            raise ValueError(f"{what} field {k}: each depth row must be "
                             "contiguous, every field of the subpath the "
                             "same lanes apart from one depth to the next")
        if v.shape[0] > 1:
            stride = step // width
        if depth is not None and v.shape[0] != depth:
            raise ValueError(f"{what} fields hold different depths")
        depth = v.shape[0]
        ptrs.append(v.data_ptr())
    return ptrs, (n if stride is None else stride), depth


def _camera(cam, keys, dev):
    """Pointers of the camera's device tensors ``keys``."""
    return [kernels.checked(cam[k], torch.float32,
                            () if k.startswith("phys") else (3,), dev,
                            f"camera {k}").data_ptr() for k in keys]


def _materials(mat, keys, dev):
    """Pointers of the material table's ``keys``, then its row count."""
    m = mat["type"].shape[0]
    out = [kernels.checked(mat[k],
                           torch.int32 if k == "type" else torch.float32,
                           (m,) if k == "type" else (m, 3), dev,
                           f"material {k}").data_ptr() for k in keys]
    if m <= CAMERA_MATERIAL:
        raise ValueError(f"the material table has {m} rows: the sensor's "
                         f"material is row {CAMERA_MATERIAL}")
    return out + [m]


@functools.lru_cache(maxsize=None)
def _host_pairs(pairs):
    """The pairs as a host array of 2P ints, which the entry copies into
    the launch's parameters (kept alive by the cache)."""
    return (ctypes.c_int * (2 * len(pairs)))(*(v for ts in pairs for v in ts))


def rays_kernel(cam_path, light_path, scene, pairs, any_hit: bool):
    """``connection_rays`` through ``clive2_connect_rays``, on the device of
    the subpaths' tensors, with the specular flags derived in the kernel.
    Reads no device value on the host."""
    cam_len = cam_path["length"]
    dev, n = cam_len.device, cam_len.shape[0]
    pairs = tuple(tuple(int(v) for v in ts) for ts in pairs)
    if not pairs or len(set(pairs)) != len(pairs) or any(
            len(ts) != 2 or not 1 <= v <= MAX_BOUNCES
            for ts in pairs for v in ts):
        raise ValueError(f"the kernel takes distinct pairs (t, s) in "
                         f"[1, {MAX_BOUNCES}], got {pairs}")
    c_ptrs, c_stride, c_depth = _path_fields(cam_path, _RAY_FIELDS, n, dev,
                                             "camera")
    l_ptrs, l_stride, l_depth = _path_fields(light_path, _RAY_FIELDS, n, dev,
                                             "light")
    depth = max(v for ts in pairs for v in ts)
    if depth > min(c_depth, l_depth):
        raise ValueError(f"pairs reach depth {depth}, the subpaths hold "
                         f"{min(c_depth, l_depth)} vertices")
    lens = [kernels.checked(path["length"], torch.int32, (n,), dev,
                            f"{what} length").data_ptr()
            for what, path in (("camera", cam_path), ("light", light_path))]
    mat_type, n_mat = _materials(scene["mat"], ("type",), dev)
    cam = _camera(scene["camera"], ("center", "focal_point", "direction"),
                  dev)
    p = len(pairs)
    origin = torch.empty((p, n, 3), device=dev)
    direction = torch.empty((p, n, 3), device=dev)
    active = torch.empty((p, n), dtype=torch.bool, device=dev)
    t_max = torch.empty((p, n), device=dev)
    if n:
        kernels.call("clive2_connect_rays", dev, *c_ptrs, c_stride, *l_ptrs,
                     l_stride, *lens, n, depth, mat_type, n_mat, *cam,
                     ctypes.addressof(_host_pairs(pairs)), p, int(any_hit),
                     origin.data_ptr(), direction.data_ptr(),
                     active.data_ptr(), t_max.data_ptr())
        rays_kernel.launches += 1
    return origin, direction, active, t_max


rays_kernel.launches = 0


def shade_kernel(cam_path, light_path, scene, cast_tri, cast_t, cast_active,
                 width: int, height: int, max_bounces: int = MAX_BOUNCES):
    """``shade`` through ``clive2_connect_shade``, on the device of the
    tensors, under the estimator ``constants.REFERENCE_MIS`` names at this
    call.  Reads no device value on the host."""
    cam_len = cam_path["length"]
    dev, n = cam_len.device, cam_len.shape[0]
    if not 1 <= max_bounces <= MAX_BOUNCES:
        raise ValueError(f"max_bounces={max_bounces}: the kernel takes 1 to "
                         f"{MAX_BOUNCES}")
    c_ptrs, c_stride, c_depth = _path_fields(
        cam_path, _SHADE_FIELDS + ("hit_light",), n, dev, "camera")
    l_ptrs, l_stride, l_depth = _path_fields(light_path, _SHADE_FIELDS, n,
                                             dev, "light")
    if max_bounces > min(c_depth, l_depth):
        raise ValueError(f"max_bounces={max_bounces}, the subpaths hold "
                         f"{min(c_depth, l_depth)} vertices")
    kernels.checked(cam_len, torch.int32, (n,), dev, "camera length")
    pn = (max_bounces ** 2, n)
    casts = [kernels.checked(x, dtype, pn, dev, f"cast {what}").data_ptr()
             for x, dtype, what in ((cast_tri, torch.int32, "triangles"),
                                    (cast_t, torch.float32, "t"),
                                    (cast_active, torch.bool, "active"))]
    mat = _materials(scene["mat"], ("type", "color", "emission"), dev)
    packed = scene["tri"]["packed"]
    if (packed.dtype != torch.float32 or packed.dim() != 2
            or packed.shape[1] <= 14 or packed.stride(1) != 1
            or packed.device != dev):
        raise ValueError("scene tri packed must be f32 [T, >= 15] rows on "
                         f"{dev}")
    cam = _camera(scene["camera"], ("center", "focal_point", "direction",
                                    "dx", "dy", "phys_width", "phys_height"),
                  dev)
    contribution = torch.empty((n, 3), device=dev)
    weight_sum = torch.empty(n, device=dev)
    light_image = torch.zeros((width * height, 3), device=dev)
    light_weight = torch.zeros(width * height, device=dev)
    if n:
        kernels.call("clive2_connect_shade", dev, *c_ptrs, c_stride, *l_ptrs,
                     l_stride, cam_len.data_ptr(), n, max_bounces, *casts,
                     *mat, packed.data_ptr(), packed.stride(0),
                     packed.shape[0], *cam, width, height,
                     int(constants.REFERENCE_MIS), contribution.data_ptr(),
                     weight_sum.data_ptr(), light_image.data_ptr(),
                     light_weight.data_ptr())
        shade_kernel.launches += 1
    return contribution, weight_sum, light_image, light_weight


shade_kernel.launches = 0


def cast_connections(origin, direction, active, t_max, scene, any_hit: bool,
                     sort):
    """Stage A's cast of ``connection_rays`` as one batch (or compacted
    under ``CLIVE2_CONNECT_K``).  Returns (tri [P, N], t [P, N])."""
    p_cnt, n = active.shape
    k = connect_k()
    if 0 < k < p_cnt:
        return _compacted_cast(origin, direction, active, t_max, scene, k,
                               sort, any_hit)
    hit_i, hit_t, _, _ = intersect_scene(
        origin.reshape(p_cnt * n, 3), direction.reshape(p_cnt * n, 3),
        scene, active=active.reshape(-1), t_max=t_max.reshape(-1),
        any_hit=any_hit, sort=sort)
    return hit_i.reshape(p_cnt, n), hit_t.reshape(p_cnt, n)


@spanned("connect")
def connect_paths(cam_path, light_path, scene, width: int, height: int,
                  max_bounces: int = MAX_BOUNCES,
                  debug_per_strategy: bool = False, sort=None):
    """All-strategies BDPT connection for a wavefront of path pairs.

    Returns dict:
      contribution [N, 3]        (t != 1 strategies, per camera pixel)
      contrib_weight_sum [N]
      light_image [H, W, 3]      (t == 1 splats, scatter-added)
      light_weight_image [H, W]
      n_rays                     connection rays cast

    On the card stage A's rays are one launch of ``clive2_connect_rays`` and
    stage B one of ``clive2_connect_shade`` (csrc/connect.cu); on the CPU
    their plain versions run.

    ``debug_per_strategy`` adds ``per_strategy``: (t, s) -> dict(weighted
    [H, W, 3], unweighted [H, W, 3], weight [H, W]) full-frame images of that
    one strategy (t=1 splats scattered by their pixel).  The wavefront must
    be whole frames: lane i is pixel i mod W*H, and the frames' images are
    summed, so that one call can carry many samples.  A diagnostic for the
    convergence oracles, built only when asked for: it runs the plain
    versions of both stages on any device, the card included.

    ``sort`` is the cast's Morton-sort policy (``intersect_scene``); None
    reads ``CLIVE2_CONNECT_SORT``.
    """
    any_hit = not constants.REFERENCE_MIS and any_hit_casts()
    cast_sort = sort_knob("CLIVE2_CONNECT_SORT") if sort is None else sort
    pairs = connection_pairs(max_bounces)

    # ---- stage A: all (t, s) ray casts as ONE batched cast ----------------
    rays = connection_rays_plain if debug_per_strategy else connection_rays
    origin, direction, cast_active, t_max = rays(
        cam_path, light_path, scene, pairs, None, None, any_hit)
    cast_tri, cast_t = cast_connections(origin, direction, cast_active,
                                        t_max, scene, any_hit, cast_sort)
    del origin, direction, t_max

    # ---- stage B: per-strategy MIS + contributions ------------------------
    args = (cam_path, light_path, scene, cast_tri, cast_t, cast_active,
            width, height, max_bounces)
    per_strategy = {}
    if debug_per_strategy:
        images = shade_plain(*args, per_strategy=per_strategy)
    else:
        images = shade(*args)
    contribution, contrib_weight, light_image, light_w = images
    out = dict(
        contribution=contribution,
        contrib_weight_sum=contrib_weight,
        light_image=light_image.reshape(height, width, 3),
        light_weight_image=light_w.reshape(height, width),
        n_rays=cast_active.sum(),
    )
    if debug_per_strategy:
        out["per_strategy"] = per_strategy
    return out


def shade(cam_path, light_path, scene, cast_tri, cast_t, cast_active,
          width: int, height: int, max_bounces: int = MAX_BOUNCES):
    """Stage B: every (t, s) strategy's balance-heuristic weight and
    contribution from the cast's answers ([P, N] in ``connection_pairs``
    order).  Returns (contribution [N, 3] of the t != 1 strategies,
    contrib_weight_sum [N], light_image [H*W, 3] and light_weight_image
    [H*W] of the t = 1 splats; splats off the image are dropped).

    On CUDA tensors the kernel ``clive2_connect_shade`` (``shade_kernel``);
    on CPU tensors the plain version."""
    if cast_tri.device.type == "cpu":
        return shade_plain(cam_path, light_path, scene, cast_tri, cast_t,
                           cast_active, width, height, max_bounces)
    return shade_kernel(cam_path, light_path, scene, cast_tri, cast_t,
                        cast_active, width, height, max_bounces)


def shade_plain(cam_path, light_path, scene, cast_tri, cast_t, cast_active,
                width: int, height: int, max_bounces: int = MAX_BOUNCES,
                per_strategy=None):
    """``shade`` as tensor ops, on any device: the per-strategy MIS chains
    unrolled into masked elementwise ops over the wavefront, the t=1
    splats one scatter-add per image.  ``per_strategy``, a dict, receives
    each strategy's debug images (``connect_paths(debug_per_strategy=
    True)``)."""
    shade_plain.calls += 1
    reference = constants.REFERENCE_MIS
    CV, cam_len = cam_path["vertices"], cam_path["length"]
    LV = light_path["vertices"]
    mat = scene["mat"]
    dev = cam_len.device
    n = cam_len.shape[0]
    debug = per_strategy is not None
    pre = precompute_mis(CV, LV, mat)
    pair_index = {ts: i for i, ts in
                  enumerate(connection_pairs(max_bounces))}

    contribution = torch.zeros((n, 3), device=dev)
    contrib_weight = torch.zeros(n, device=dev)
    splat_pix, splat_val, splat_wgt = [], [], []

    def record(t, s, valid, w, est, pix=None):
        """One strategy's debug images; est is its UNWEIGHTED estimate
        per lane (already masked)."""
        wv = torch.where(valid, w, 0.0)
        imgs = (est, wv[:, None] * est, wv)
        if pix is None:                # whole frames, summed
            imgs = (x.reshape((-1, width * height) + x.shape[1:]).sum(0)
                    for x in imgs)
        else:                          # t=1: scattered by splat pixel
            imgs = (_splat_image(pix, x, width, height) for x in imgs)
        img_u, img_w, img_ww = imgs
        per_strategy[(t, s)] = dict(
            weighted=img_w.reshape(height, width, 3),
            unweighted=img_u.reshape(height, width, 3),
            weight=img_ww.reshape(height, width))

    for t in range(1, max_bounces + 1):
        for s in range(0, max_bounces + 1):
            if t + s < 2:
                continue
            if t == 1:
                idx = pair_index[(t, s)]
                pix, val, wgt, dbg = _strategy_t1(
                    t, s, CV, LV, scene, width, height, cast_tri[idx],
                    cast_t[idx], cast_active[idx], pre, debug=debug)
                splat_pix.append(pix)
                splat_val.append(val)
                splat_wgt.append(wgt)
                if debug:
                    record(t, s, *dbg, pix=pix)
                continue
            cv = _vstatic(CV, t - 1)
            if s == 0:
                valid = (t <= cam_len) & (cv["hit_light"] >= 0)
                g = torch.ones(n, device=dev)
                emission = gather_rows(mat["emission"], cv["material"])
                color = _vstatic(CV, t - 2)["color"] * emission
                p_s = cv["tot_importance"]
                if reference:
                    w, p_s, ok = _mis_weight_fast(t, s, pre, p_s)
                else:
                    w, p_s, ok = _mis_weight_correct(
                        t, s, pre, p_s, l0_override=pre["L"]["l"][0])
            else:
                idx = pair_index[(t, s)]
                lv = _vstatic(LV, s - 1)
                if reference:
                    visible = (
                        (cast_tri[idx] >= 0)
                        & (cast_tri[idx] != lv["triangle"])
                        & (cast_tri[idx] == cv["triangle"])
                    )
                else:
                    # robust visibility: with the cast capped below the
                    # segment length, "no hit strictly inside the segment"
                    # means unoccluded
                    seg = cv["origin"] - lv["origin"]
                    seg_len = torch.sqrt(torch.clamp(dot(seg, seg),
                                                     min=1e-30))
                    visible = (
                        (cast_tri[idx] == cv["triangle"])
                        | (cast_tri[idx] < 0)
                        | (cast_t[idx] >= seg_len * (1.0 - 1e-3))
                    )
                valid = cast_active[idx] & visible
                dir_l_to_c = normalize(cv["origin"] - lv["origin"])
                if reference:
                    # cos/pi junction "BRDFs" and a geometry term from the
                    # stored directions
                    new_camera_f = dot(-dir_l_to_c, cv["normal"]).abs() / PI
                    g = _geom(cv, lv)
                else:
                    # diffuse BRDF 1/pi; the junction cosines belong to the
                    # geometry term, with the actual connection direction
                    new_camera_f = torch.full_like(cv["tot_importance"],
                                                   INV_PI)
                    delta_j = cv["origin"] - lv["origin"]
                    d2_j = torch.clamp(dot(delta_j, delta_j), min=1e-30)
                    g = (dot(dir_l_to_c, lv["normal"]).abs()
                         * dot(dir_l_to_c, cv["normal"]).abs() / d2_j)
                camera_color = (
                    _vstatic(CV, t - 2)["color"]
                    * new_camera_f[:, None]
                    * gather_rows(mat["color"], cv["material"])
                )
                if s == 1:
                    light_color = gather_rows(mat["emission"],
                                              lv["material"])
                else:
                    if reference:
                        new_light_f = dot(dir_l_to_c,
                                          lv["normal"]).abs() / PI
                    else:
                        new_light_f = torch.full_like(lv["tot_importance"],
                                                      INV_PI)
                        if s == 2:
                            # the emission cosine lives in color(y_1)
                            # onward (trace folds it at the first light
                            # bounce); s == 2 uses color(y_0) and needs it
                            # explicitly
                            y0 = _vstatic(LV, 0)
                            new_light_f = new_light_f * dot(
                                y0["direction"], y0["normal"]).abs()
                    light_color = (
                        _vstatic(LV, s - 2)["color"]
                        * new_light_f[:, None]
                        * gather_rows(mat["color"], lv["material"])
                    )
                color = camera_color * light_color
                p_s = cv["tot_importance"] * lv["tot_importance"]
                delta = cv["origin"] - lv["origin"]
                d_x = torch.clamp(dot(delta, delta), min=1e-30)
                if reference:
                    w, p_s, ok = _mis_weight_fast(t, s, pre, p_s, Dx=d_x)
                else:
                    dj = normalize(cv["origin"] - lv["origin"])
                    w, p_s, ok = _mis_weight_correct(
                        t, s, pre, p_s, Dx=d_x,
                        jcos_l=dot(dj, lv["normal"]).abs(),
                        jcos_c=dot(dj, cv["normal"]).abs(),
                    )
            valid &= ok
            contrib = (w * g / torch.clamp(p_s, min=1e-38))[:, None] * color
            contribution += torch.where(valid[:, None], contrib, 0.0)
            contrib_weight += torch.where(valid, w, 0.0)
            if debug:
                record(t, s, valid, w, torch.where(
                    valid[:, None],
                    (g / torch.clamp(p_s, min=1e-38))[:, None] * color, 0.0))

    # one scatter-add per channel over the concatenated t=1 strategies;
    # out-of-image splats carry pixel W*H and are dropped
    pix = torch.cat(splat_pix)
    keep = pix < width * height
    pix = pix[keep].long()
    light_image = torch.zeros(width * height, 3, device=dev)
    light_image.index_add_(0, pix, torch.cat(splat_val)[keep])
    light_w = torch.zeros(width * height, device=dev)
    light_w.index_add_(0, pix, torch.cat(splat_wgt)[keep])
    return contribution, contrib_weight, light_image, light_w


shade_plain.calls = 0


def _strategy_t1(t, s, CV, LV, scene, width, height, hit_i, hit_t, active,
                 pre, debug=False):
    """t=1: project light vertex s-1 onto the physical camera plane and
    emit a splat.  Returns (pixel or W*H when dropped, value, weight, and
    with ``debug`` (valid, w, unweighted estimate), else None)."""
    reference = constants.REFERENCE_MIS
    mat = scene["mat"]
    cam = scene["camera"]
    n = hit_i.shape[0]
    dev = hit_i.device

    lv = _vstatic(LV, s - 1)
    proj_dir = normalize(cam["focal_point"] - lv["origin"])

    safe_i = torch.clamp(hit_i, min=0)
    reached = (hit_i >= 0) & (
        gather_rows(scene["tri"]["packed"], safe_i)[:, 14] != 0)
    if reference:
        camera_point = lv["origin"] + hit_t[:, None] * proj_dir
    else:
        # robust sensor reach: intersect the sensor PLANE analytically and
        # accept when no scene hit lies strictly inside the segment
        den = dot(proj_dir, cam["direction"])
        num = dot(cam["center"] - lv["origin"], cam["direction"])
        t_plane = torch.where(den < -1e-12, num / den, float("inf"))
        reached = (
            reached | (hit_i < 0) | (hit_t >= t_plane * (1.0 - 1e-3))
        ) & torch.isfinite(t_plane) & (t_plane > 0)
        camera_point = lv["origin"] + t_plane[:, None] * proj_dir

    rel = camera_point - cam["center"]
    x = (dot(rel, cam["dx"]) / cam["phys_width"] + 0.5) * width
    y = (dot(rel, cam["dy"]) / cam["phys_height"] + 0.5) * height
    # the reference's round() (half to even, as jnp.round) shifts the splat
    # grid by half a pixel against the camera rays' pixel footprints
    to_pixel = torch.round if reference else torch.floor
    px = to_pixel(x).to(torch.int32)
    py = to_pixel(y).to(torch.int32)
    pix_ok = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    pixel = py * width + px

    valid = active & reached & pix_ok

    # the synthetic camera vertex on the sensor has tot_importance 1
    p_s = lv["tot_importance"]
    delta = camera_point - lv["origin"]
    d_x = torch.clamp(dot(delta, delta), min=1e-30)
    spec_synth = (mat["type"][7] > 0).expand(n)
    dir_l_to_c = normalize(camera_point - lv["origin"])
    prior = _vstatic(LV, max(0, s - 2))
    lcolor = prior["color"] * gather_rows(mat["color"], lv["material"])
    if reference:
        synth = dict(origin=camera_point,
                     direction=normalize(cam["focal_point"] - camera_point),
                     normal=cam["direction"].expand(n, 3))
        w, p_s, ok = _mis_weight_fast(
            t, s, pre, p_s, Dx=d_x,
            w_synth=dot(synth["direction"], synth["normal"]).abs(),
            spec_synth=spec_synth)
        if s > 1:
            new_light_f = dot(dir_l_to_c, lv["normal"]).abs() / PI
        else:
            new_light_f = torch.ones(n, device=dev)
        shade = new_light_f * _geom(lv, synth)
    else:
        w, p_s, ok = _mis_weight_correct(
            t, s, pre, p_s, Dx=d_x,
            jcos_l=dot(dir_l_to_c, lv["normal"]).abs(),
            jcos_c=dot(dir_l_to_c, cam["direction"]).abs(),
            spec_synth=spec_synth,
            t1_cam_c=pre["C"]["c"][0],
        )
        # unbiased splat: radiance toward the sensor times the light->pixel
        # area Jacobian through the pinhole,
        # phys_w * phys_h * (cosL / cosC) * (r1 / r0)^2
        if s > 1:
            brdf = torch.full((n,), INV_PI, device=dev)
            if s == 2:
                y0 = _vstatic(LV, 0)
                brdf = brdf * dot(y0["direction"], y0["normal"]).abs()
        else:
            brdf = torch.ones(n, device=dev)
        cos_l = dot(dir_l_to_c, lv["normal"]).abs()
        cos_c = torch.clamp(dot(dir_l_to_c, cam["direction"]).abs(),
                            min=1e-6)
        to_focal0 = cam["focal_point"] - lv["origin"]
        to_focal1 = cam["focal_point"] - camera_point
        r0 = torch.sqrt(torch.clamp(dot(to_focal0, to_focal0), min=1e-30))
        r1 = torch.sqrt(torch.clamp(dot(to_focal1, to_focal1), min=1e-30))
        k_sensor = cam["phys_width"] * cam["phys_height"]
        shade = brdf * k_sensor * (cos_l / cos_c) * (r1 / r0) ** 2
    valid &= ok

    value = (w * shade / torch.clamp(p_s, min=1e-38))[:, None] * lcolor
    pix_out = torch.where(valid, pixel, width * height)
    dbg = None
    if debug:
        est = torch.where(valid[:, None], (
            shade / torch.clamp(p_s, min=1e-38))[:, None] * lcolor, 0.0)
        dbg = (valid, w, est)
    return (pix_out, torch.where(valid[:, None], value, 0.0),
            torch.where(valid, w, 0.0), dbg)


def precompute_mis(CV, LV, mat):
    """Shared MIS-chain terms, computed once per sample: per-vertex cosine
    weights, stored dual importances, specular flags and per-edge squared
    distances, identical across strategies except at the junction."""
    def per_path(V):
        w = (V["direction"] * V["normal"]).sum(-1).abs()          # [D, N]
        spec = specular(V, mat)
        delta = V["origin"][1:] - V["origin"][:-1]
        dist2 = torch.clamp((delta * delta).sum(-1), min=1e-30)
        # cosine of vertex d's normal against its INCOMING edge (in_cos[0]
        # is never read)
        in_cos = torch.cat(
            [w[0:1],
             (V["direction"][:-1] * V["normal"][1:]).sum(-1).abs()], dim=0)
        return dict(w=w, in_cos=in_cos, l=V["l_importance"],
                    c=V["c_importance"], spec=spec, D=dist2)

    return dict(L=per_path(LV), C=per_path(CV))


def _mis_weight_correct(t, s, pre, p_s, Dx=None, jcos_l=None, jcos_c=None,
                        spec_synth=None, l0_override=None, t1_cam_c=None):
    """Balance-heuristic weight with consistent junction pdfs and cosines
    (the JAX package's ``_mis_weight_correct``, term for term).

    jcos_l/jcos_c = |cos| of the junction edge at the light/camera junction
    vertices (None when s == 0); l0_override replaces vertex 0's
    l_importance for s == 0 (the light-area pdf); t1_cam_c = the sensor
    c_importance for the t == 1 light-junction override.
    """
    k = s + t
    L, C = pre["L"], pre["C"]

    def vert_l(i):
        if i == 0 and s == 0:
            return l0_override
        if i == 1:
            # the hypothetical light subpath's first direction is sampled
            # uniform-hemisphere at the light surface: pdf 1/2pi
            return torch.full_like(p_s, INV_2PI)
        if i == s and s >= 1:          # camera junction (or t=1 synthetic)
            return jcos_l / PI
        if i < s:
            return L["l"][i]
        return C["l"][t + s - 1 - i]

    def vert_c(i):
        if i == s - 1 and s >= 1:      # light junction
            return t1_cam_c if t == 1 else jcos_c / PI
        if i < s:
            return L["c"][i]
        return C["c"][t + s - 1 - i]

    def vert_spec(i):
        if i < s:
            return L["spec"][i]
        j = t + s - 1 - i
        if t == 1 and j == 0:
            return spec_synth
        return C["spec"][j]

    def cos_light_side(i):
        """|cos| at vertex x_i against its light-side edge e_{i-1}."""
        if i - 1 == s - 1 and s >= 1:
            return jcos_c
        if i - 1 <= s - 2:
            return L["in_cos"][i]
        return C["w"][t + s - 1 - i]

    def cos_cam_side(i):
        """|cos| at vertex x_i against its camera-side edge e_i."""
        if i == s - 1 and s >= 1:
            return jcos_l
        if i <= s - 2:
            return L["w"][i]
        return C["in_cos"][t + s - 1 - i]

    def edge_D(e):
        if s >= 1 and e == s - 1:
            return Dx
        if e <= s - 2:
            return L["D"][e]
        j = t + s - 1 - e              # edge (cam[j], cam[j-1])
        return C["D"][j - 1]

    ratios = []
    for i in range(k):
        if i == 0:
            num = vert_l(0)
            den = vert_c(0) * cos_cam_side(0) / edge_D(0)
        elif i == k - 1:
            num = vert_l(k - 1) * cos_light_side(k - 1) / edge_D(k - 2)
            den = vert_c(k - 1)
        else:
            num = vert_l(i) * cos_light_side(i) / edge_D(i - 1)
            den = vert_c(i) * cos_cam_side(i) / edge_D(i)
        ratios.append(num / torch.where(den.abs() > 1e-38, den, 1e-38))
    return _balance(k, s, p_s, ratios, [vert_spec(i) for i in range(k)])


def _mis_weight_fast(t, s, pre, p_s, Dx=None, w_synth=None, spec_synth=None):
    """Balance-heuristic weight of the reference estimator from the
    precomputed terms (the JAX package's ``_mis_weight_fast``, term for
    term).  It mirrors :func:`_mis_weight`, the direct transcription of the
    reference's chain (trace.metal:693-776): each ratio is num/den with the
    same factors and guards, the geometry terms looked up instead of
    recomputed.

    Dx: junction squared distance between light[s-1] and the camera-side
    vertex (s >= 1); w_synth/spec_synth: cosine weight and specular flag of
    the t=1 synthetic camera vertex.
    """
    k = s + t
    L, C = pre["L"], pre["C"]

    def vert(i):
        if i < s:
            return L["w"][i], L["l"][i], L["c"][i], L["spec"][i]
        j = t + s - 1 - i
        if t == 1 and j == 0:
            return w_synth, C["l"][0], C["c"][0], spec_synth
        return C["w"][j], C["l"][j], C["c"][j], C["spec"][j]

    def edge(e):
        # squared distance between vx[e] and vx[e+1]
        if e <= s - 2:
            return L["D"][e]
        if e == s - 1 and s >= 1:
            return Dx
        return C["D"][t + s - 2 - e]      # camera edge (cam[j], cam[j+1])

    v = [vert(i) for i in range(k)]

    ratios = []
    for i in range(k):
        if i == 0:
            w0, l0, c0, _ = v[0]
            num = l0
            den = c0 * (w0 * v[1][0] / edge(0))
        elif i == k - 1:
            wk, lk, ck, _ = v[k - 1]
            num = lk * (wk * v[k - 2][0] / edge(k - 2))
            den = ck
        else:
            wi, li, ci, _ = v[i]
            num = li * (v[i - 1][0] * wi / edge(i - 1))
            den = ci * (wi * v[i + 1][0] / edge(i))
        ratios.append(num / torch.where(den.abs() > 1e-38, den, 1e-38))
    return _balance(k, s, p_s, ratios, [x[3] for x in v])


def _balance(k, s, p_s, ratios, spec):
    """The balance heuristic from the chain's pdf ratios p_{i+1}/p_i and the
    vertices' specular flags: (w, p_s, ok), as the reference computes it."""
    p_values = [None] * (k + 1)
    p_values[s] = p_s
    for i in range(s, k):
        p_values[i + 1] = p_values[i] * ratios[i]
    for i in range(s - 1, -1, -1):
        p_values[i] = p_values[i + 1] / torch.where(
            ratios[i].abs() > 1e-38, ratios[i], 1e-38)

    # specular vertices cannot be connection endpoints: zero their
    # hypothetical strategies
    for i in range(k):
        p_values[i] = torch.where(spec[i], 0.0, p_values[i])
        p_values[i + 1] = torch.where(spec[i], 0.0, p_values[i + 1])
    p_values[k] = torch.zeros_like(p_s)

    total = p_values[0]
    for i in range(1, k + 1):
        total = total + p_values[i]

    ok = (p_values[s] > 0.0) & (total > 0.0)
    w = torch.where(ok, p_values[s] / torch.where(total > 0.0, total, 1.0),
                    0.0)
    return w, p_s, ok


def _mis_weight(t, s, CV, LV, cv, lv, mat, cv_synthetic=None):
    """Balance-heuristic weight for strategy (t, s), the direct
    transcription of the reference's chain (trace.metal:693-776) that
    :func:`_mis_weight_fast` is held to.

    Vertices are indexed from the light end: x_i = light[i] for i < s,
    x_i = camera[t+s-1-i] otherwise; for t == 1 the camera vertex is the
    synthetic projected vertex.  Uses each vertex's stored dual importances,
    the chain endpoints' stale values included.  Returns (w, p_s, ok).
    """
    k = s + t

    def vertex(i):
        if i < s:
            return _vstatic(LV, i)
        j = t + s - 1 - i
        if t == 1 and j == 0:
            return cv_synthetic if cv_synthetic is not None else cv
        return _vstatic(CV, j)

    vx = [vertex(i) for i in range(k)]

    ratios = []
    for i in range(k):
        if i == 0:
            a, b = vx[0], vx[1]
            num = a["l_importance"]
            den = a["c_importance"] * _geom(a, b)
        elif i == k - 1:
            a, b = vx[k - 1], vx[k - 2]
            num = a["l_importance"] * _geom(a, b)
            den = a["c_importance"]
        else:
            a, b, c = vx[i - 1], vx[i], vx[i + 1]
            num = b["l_importance"] * _geom(a, b)
            den = b["c_importance"] * _geom(b, c)
        ratios.append(num / torch.where(den.abs() > 1e-38, den, 1e-38))

    light_tot = (torch.ones_like(cv["tot_importance"]) if s == 0
                 else lv["tot_importance"])
    p_s = cv["tot_importance"] * light_tot
    spec = [gather_rows(mat["type"], v["material"]) > 0 for v in vx]
    return _balance(k, s, p_s, ratios, spec)
