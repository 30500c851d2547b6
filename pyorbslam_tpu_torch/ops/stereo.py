"""Stereo keypoint matching: epipolar-band Hamming + SAD sub-pixel refine.

Port of ``pyorbslam_tpu/ops/stereo.py`` (reference:
Frame.compute_stereo_matches, Frame.py:161-279): candidate gating (row
band +-2*scaleFactor[octave_R], octave within +-1, disparity in [0,
bf/b)) as masks over the full Hamming matrix; best match below (TH_HIGH
+ TH_LOW)/2; an 11x11 centre-subtracted SAD slid +-5 px at the left
keypoint's level with a parabola fit; then upstream ORB-SLAM2's
median-SAD outlier cut.  Outputs (u_right, depth) with -1 where
unmatched.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.ops import hamming as ham
from pyorbslam_tpu_torch.utils.host_read import device_constant

W_SAD = 5    # half window of the SAD patch (11x11)
L_SLIDE = 5  # slide range +-5 px


class PyramidAtlas(NamedTuple):
    """All pyramid levels flattened into one 1-D buffer for mixed-level
    gathers: pixel (x, y) of level l lives at offset[l] + y*width[l] + x."""

    flat: torch.Tensor      # (sum(H_l * W_l),) float32
    offsets: torch.Tensor   # (L,) int64
    widths: torch.Tensor    # (L,) int64
    heights: torch.Tensor   # (L,) int64


def build_atlas(levels: List[torch.Tensor]) -> PyramidAtlas:
    dev = levels[0].device
    offsets = np.cumsum([0] + [int(l.shape[0] * l.shape[1]) for l in levels[:-1]])
    return PyramidAtlas(
        flat=torch.cat([l.reshape(-1) for l in levels]),
        offsets=device_constant(offsets, torch.int64, dev),
        widths=device_constant([l.shape[1] for l in levels], torch.int64, dev),
        heights=device_constant([l.shape[0] for l in levels], torch.int64, dev),
    )


def _atlas_gather(atlas: PyramidAtlas, level: torch.Tensor,
                  ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Clamped gather: level (N,), ys/xs (N, ...) -> (N, ...) float32."""
    level = level.long()
    extra = (1,) * (ys.dim() - 1)
    wb = atlas.widths[level].reshape(level.shape + extra)
    hb = atlas.heights[level].reshape(level.shape + extra)
    ob = atlas.offsets[level].reshape(level.shape + extra)
    ysc = torch.minimum(torch.clamp(ys, min=0), hb - 1)
    xsc = torch.minimum(torch.clamp(xs, min=0), wb - 1)
    return atlas.flat[ob + ysc * wb + xsc]


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x[mask]`` as ``jnp.nanmedian`` computes it: the mean of
    the two middle values for an even count (``torch.nanmedian`` returns
    the lower one).  No host read-back.  Undefined for an empty mask."""
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))))[0]
    count = mask.sum()
    lo = torch.clamp((count - 1) // 2, min=0)
    hi = torch.clamp(count // 2, min=0)
    # a gather: indexing with a 0-dim tensor would read it back to the host
    mid = torch.gather(vals, 0, torch.stack([lo, hi]))
    return 0.5 * mid[0] + 0.5 * mid[1]


def match_stereo(
    xy_l: torch.Tensor, oct_l: torch.Tensor, desc_l: torch.Tensor, valid_l: torch.Tensor,
    xy_r: torch.Tensor, oct_r: torch.Tensor, desc_r: torch.Tensor, valid_r: torch.Tensor,
    atlas_l: PyramidAtlas, atlas_r: PyramidAtlas,
    scale_factors: torch.Tensor,  # (L,) float32, 1.2^l
    bf: float,
    max_disparity: float,         # = fx: maxD = bf / minZ with minZ = baseline
    min_disparity: float = 0.0,
    th_orb: float = 75.0,         # (TH_HIGH + TH_LOW) / 2
    sad_median_filter: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (u_right, depth), each (N,) float32 with -1 where unmatched."""
    dev = xy_l.device
    inv_scale = 1.0 / scale_factors
    oct_l = oct_l.long()
    oct_r = oct_r.long()

    # ---- candidate gating over the full distance matrix ----
    dist = ham.hamming_matrix(desc_l, desc_r)  # (N, M) int32

    vl_int = torch.floor(xy_l[:, 1]).to(torch.int32)
    r_band = 2.0 * scale_factors[oct_r]                       # (M,)
    row_ok = (
        (vl_int[:, None] >= torch.floor(xy_r[None, :, 1] - r_band[None, :]))
        & (vl_int[:, None] <= torch.ceil(xy_r[None, :, 1] + r_band[None, :]))
    )
    oct_ok = torch.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    disp_ok = (disp >= min_disparity) & (disp <= max_disparity)

    mask = (
        row_ok & oct_ok & disp_ok
        & valid_l[:, None] & valid_r[None, :]
    )
    dist = torch.where(mask, dist, torch.full_like(dist, 10_000))
    best_idx = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    matched = best_dist < th_orb

    # ---- SAD sub-pixel refinement at the left keypoint's level ----
    sf_l = scale_factors[oct_l]            # (N,)
    inv_l = inv_scale[oct_l]
    u_r0 = xy_r[best_idx, 0]
    su_l = torch.round(xy_l[:, 0] * inv_l).long()
    sv_l = torch.round(xy_l[:, 1] * inv_l).long()
    su_r0 = torch.round(u_r0 * inv_l).long()

    offs = torch.arange(-W_SAD, W_SAD + 1, dtype=torch.int64, device=dev)
    wide = torch.arange(-W_SAD - L_SLIDE, W_SAD + L_SLIDE + 1,
                        dtype=torch.int64, device=dev)

    patch_l = _atlas_gather(
        atlas_l, oct_l,
        sv_l[:, None, None] + offs[None, :, None],
        su_l[:, None, None] + offs[None, None, :],
    )  # (N, 11, 11)
    patch_l = patch_l - patch_l[:, W_SAD, W_SAD][:, None, None]

    strip_r = _atlas_gather(
        atlas_r, oct_l,
        sv_l[:, None, None] + offs[None, :, None],
        su_r0[:, None, None] + wide[None, None, :],
    )  # (N, 11, 21)

    sads = []
    for inc in range(2 * L_SLIDE + 1):
        win = strip_r[:, :, inc: inc + 2 * W_SAD + 1]
        win = win - win[:, W_SAD, W_SAD][:, None, None]
        sads.append(torch.abs(patch_l - win).sum(dim=(1, 2)))
    sad = torch.stack(sads, dim=1)  # (N, 11), index inc+5 for shift inc

    best_inc_idx = torch.argmin(sad, dim=1)
    interior = (best_inc_idx > 0) & (best_inc_idx < 2 * L_SLIDE)
    safe_idx = torch.clamp(best_inc_idx, 1, 2 * L_SLIDE - 1)
    d1 = torch.gather(sad, 1, safe_idx[:, None] - 1)[:, 0]
    d2 = torch.gather(sad, 1, safe_idx[:, None])[:, 0]
    d3 = torch.gather(sad, 1, safe_idx[:, None] + 1)[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = torch.where(torch.abs(denom) > 1e-9, (d1 - d3) / denom,
                        torch.full_like(denom, 2.0))
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    # reference bound check: the 21-wide strip must fit in the level
    width_l = atlas_r.widths[oct_l]
    bounds_ok = (su_r0 + L_SLIDE - W_SAD >= 0) & (
        su_r0 + L_SLIDE + W_SAD + 1 < width_l
    )

    best_u_r = sf_l * (
        su_r0.to(torch.float32)
        + (safe_idx.to(torch.float32) - L_SLIDE)
        + delta
    )
    disparity = xy_l[:, 0] - best_u_r
    in_range = (disparity >= min_disparity) & (disparity < max_disparity)
    disp_pos = disparity > 0
    disparity = torch.where(disp_pos, disparity, torch.full_like(disparity, 0.01))
    best_u_r = torch.where(disp_pos, best_u_r, xy_l[:, 0] - 0.01)

    ok = matched & interior & delta_ok & bounds_ok & in_range & valid_l
    # upstream ORB-SLAM2 median-SAD cut: drop matches with SAD distance
    # greater than 1.5 * 1.4 * median
    if sad_median_filter:
        sad_best = d2
        med = masked_median(sad_best, ok)
        ok = ok & (sad_best <= 2.1 * med)

    u_right = torch.where(ok, best_u_r, torch.full_like(best_u_r, -1.0))
    depth = torch.where(ok, bf / disparity, torch.full_like(disparity, -1.0))
    return u_right, depth
