"""Frozen copy of clive2_tpu_torch/ops/filters.py.

3x3 Gaussian reconstruction filter (port of clive2_tpu/ops/filters.py).

Per-sample filter weights; for a raster frame or stripe the
transposed-weight neighbour gather is nine shifted adds over the image, and
for an arbitrary pixel subset one scatter-add of each sample's nine
weighted contributions.
"""

from __future__ import annotations

import torch

from .sampling import dot


def filter_weights(sensor_pos, pixel_idx, cam, width: int, height: int):
    """Per-sample normalised 3x3 Gaussian weights.

    sensor_pos [N, 3] jittered sample position on the sensor plane;
    pixel_idx [N] i32 flat pixel index (y * width + x).  Returns [N, 3, 3];
    entry [a, b] is the weight toward pixel (x + a - 1, y + b - 1),
    out-of-bounds neighbours get 0, and each sample's weights sum to 1.
    """
    pw = cam["phys_width"]
    ph = cam["phys_height"]
    pixel_w = pw / width
    pixel_h = ph / height
    sigma = 0.5 * torch.sqrt(pixel_w * pixel_w + pixel_h * pixel_h)

    px = pixel_idx % width
    py = pixel_idx // width

    offs = torch.arange(-1, 2, dtype=pixel_idx.dtype, device=pixel_idx.device)
    nx = px[:, None, None] + offs[None, :, None]     # [N, 3, 1]
    ny = py[:, None, None] + offs[None, None, :]     # [N, 1, 3]
    in_bounds = (nx >= 0) & (nx < width) & (ny >= 0) & (ny < height)

    xn = (nx - 0.5 * width) / width
    yn = (ny - 0.5 * height) / height
    centers = (
        cam["center"]
        + (xn * pw)[..., None] * cam["dx"]
        + (yn * ph)[..., None] * cam["dy"]
    )  # [N, 3, 3, 3]

    d = centers - sensor_pos[:, None, None, :]
    dist2 = dot(d, d)
    w = torch.exp(-dist2 / (2.0 * sigma * sigma))
    w = torch.where(in_bounds, w, 0.0)
    wsum = w.sum(dim=(1, 2), keepdim=True)
    return torch.where(wsum > 0.0, w / wsum, 0.0)


def finalize_samples(contribution, weights, contrib_weight_sum,
                     width: int, height: int, row0: int = None,
                     rows: int = None):
    """Filtered image + per-pixel weight sums for a raster frame.

    contribution [N, 3], weights [N, 3, 3], contrib_weight_sum [N].  With
    ``row0``/``rows`` the samples cover only image rows [row0, row0+rows),
    and the filter's one-row spill across the stripe's edges lands in the
    full-size output.  Returns (image [H, W, 3], weight_image [H, W]).  For
    output pixel p the neighbour sample at q = p + (i, j) contributes with
    its weight toward p, which is its weights[1 - i][1 - j].
    """
    local_rows = height if rows is None else rows
    c = contribution.reshape(local_rows, width, 3)
    w = weights.reshape(local_rows, width, 3, 3)
    cws = contrib_weight_sum.reshape(local_rows, width)

    # canvas with one spill row above and below: a sample at local row r
    # contributes to output row r - j = canvas row r - j + 1
    image = c.new_zeros((local_rows + 2, width, 3))
    wimage = c.new_zeros((local_rows + 2, width))
    for i in (-1, 0, 1):          # x offset
        for j in (-1, 0, 1):      # y offset
            wv = w[:, :, 1 - i, 1 - j]
            image[1 - j:1 - j + local_rows] += _shiftx(wv[..., None] * c, i)
            wimage[1 - j:1 - j + local_rows] += _shiftx(wv * cws, i)
    if rows is None:
        return image[1:-1], wimage[1:-1]
    # canvas row 0 is image row row0 - 1, i.e. row row0 of a frame padded
    # by one row at each edge
    full_i = c.new_zeros((height + 2, width, 3))
    full_w = c.new_zeros((height + 2, width))
    full_i[row0:row0 + local_rows + 2] = image
    full_w[row0:row0 + local_rows + 2] = wimage
    return full_i[1:-1], full_w[1:-1]


def finalize_samples_scatter(contribution, weights, contrib_weight_sum,
                             pixel_idx, width: int, height: int):
    """:func:`finalize_samples` for samples over an arbitrary pixel subset
    (adaptive sampling): each sample scatter-adds its nine filter-weighted
    contributions; neighbours outside the image are dropped.

    contribution [M, 3]; weights [M, 3, 3]; contrib_weight_sum [M];
    pixel_idx [M] flat indices.  Returns (image [H, W, 3], weight [H, W]).
    """
    px = pixel_idx % width
    py = pixel_idx // width
    offs = torch.arange(-1, 2, dtype=pixel_idx.dtype, device=pixel_idx.device)
    nx = px[:, None, None] + offs[None, :, None]      # [M, 3, 1]
    ny = py[:, None, None] + offs[None, None, :]      # [M, 1, 3]
    ok = ((nx >= 0) & (nx < width) & (ny >= 0) & (ny < height)).reshape(-1)
    tgt = (ny * width + nx).reshape(-1)[ok].long()   # [M * 9] kept
    vals = (weights[..., None] * contribution[:, None, None, :]).reshape(-1, 3)
    wsum = (weights * contrib_weight_sum[:, None, None]).reshape(-1)
    image = contribution.new_zeros((width * height, 3))
    image.index_add_(0, tgt, vals[ok])
    wimage = contribution.new_zeros(width * height)
    wimage.index_add_(0, tgt, wsum[ok])
    return image.reshape(height, width, 3), wimage.reshape(height, width)


def _shiftx(a, dx: int):
    """out[y, x] = a[y, x + dx], zero-padded at the x borders."""
    wd = a.shape[1]
    pad = torch.zeros_like(a[:, :1])
    ap = torch.cat([pad, a, pad], dim=1)
    return ap[:, 1 + dx:1 + dx + wd]
