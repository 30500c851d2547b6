"""FAST-9/16 corner scores, per-cell threshold fallback, NMS and spread
top-k selection.

Port of ``pyorbslam_tpu/ops/fast.py`` (reference: ORBextractor.cpp
ComputeKeyPointsOctTree:764-852).  :func:`fast_score_map` is the plain
twin of the hand-written CUDA kernel in ``csrc/fast_score.cu``; the
atlas path reaches it through :func:`pyorbslam_tpu_torch.ops.kernels.fast_score_map`.

Every top-k here is a stable descending sort sliced to k: on ties
``jax.lax.top_k`` returns the lower index first, ``torch.topk`` promises
no order, and FAST scores are integers on level 0 that tie often.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, OpenCV pixel order (x right, y down).
CIRCLE_OFFSETS = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3),
    ],
    dtype=np.int32,
)  # (dx, dy)

ARC_LEN = 9


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties broken by the lower index first
    (the order of ``jax.lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# Rows a block of the twin on the CPU: its 16 difference planes then stay
# in the cache (4x faster than the whole image at a frame's canvas); a GPU
# takes the image whole.
CPU_BLOCK_ROWS = 32


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel FAST-9 corner strength (0 where not a corner at any
    threshold > 0).  img: float32 (H, W) in [0, 255], edge-padded by 3."""
    h, w = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    rows = CPU_BLOCK_ROWS if img.device.type == "cpu" else max(h, 1)
    if rows >= h:
        return _fast_block(pad, h, w)
    return torch.cat([_fast_block(pad[r0: r0 + rows + 6], min(rows, h - r0), w)
                      for r0 in range(0, h, rows)])


def _fast_block(pad: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """FAST-9 strength of the (h, w) image inside ``pad`` (3 px of edge
    padding around it)."""
    img = pad[3: 3 + h, 3: 3 + w]

    # d[i] = p_circle_i - p_center for the 16 circle offsets
    d = torch.stack([
        pad[3 + int(dy): 3 + int(dy) + h, 3 + int(dx): 3 + int(dx) + w] - img
        for dx, dy in CIRCLE_OFFSETS
    ])  # (16, H, W)

    def arc_strength(vals):
        """max over 16 circular arcs of (min over the 9-long arc)."""
        m3 = torch.minimum(torch.minimum(vals, torch.roll(vals, -1, 0)),
                           torch.roll(vals, -2, 0))
        m9 = torch.minimum(torch.minimum(m3, torch.roll(m3, -3, 0)),
                           torch.roll(m3, -6, 0))
        return torch.amax(m9, dim=0)

    bright = arc_strength(d)        # > t  => bright corner at threshold t
    dark = arc_strength(-d)
    score = torch.maximum(bright, dark)
    return torch.clamp(score, min=0.0)


def cell_fallback_mask(
    score: torch.Tensor, ini_th: float, min_th: float, cell: int
) -> torch.Tensor:
    """Two-threshold per-cell policy -> masked score map: pixels pass at
    ini_th; in cells where no pixel passes ini_th, pixels pass at min_th."""
    h, w = score.shape
    hc = -(-h // cell)
    wc = -(-w // cell)
    padded = F.pad(score, (0, wc * cell - w, 0, hc * cell - h))
    cell_max = padded.reshape(hc, cell, wc, cell).amax(dim=(1, 3))
    has_high = cell_max > ini_th
    has_high_full = has_high.repeat_interleave(cell, 0).repeat_interleave(
        cell, 1)[:h, :w]
    keep = torch.where(has_high_full, score > ini_th, score > min_th)
    return torch.where(keep, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only pixels strictly greater than all 8 neighbours (OpenCV's
    FAST suppression drops both members of a tied plateau)."""
    h, w = score.shape
    padded = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    keep = score > 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = padded[1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
            keep &= score > neigh
    return torch.where(keep, score, torch.zeros_like(score))


def border_mask(score: torch.Tensor, border: int) -> torch.Tensor:
    """Zero scores within ``border`` px of the level edge."""
    h, w = score.shape
    out = torch.zeros_like(score)
    out[border:h - border, border:w - border] = \
        score[border:h - border, border:w - border]
    return out


def select_keypoints(
    score: torch.Tensor,
    n_keep: int,
    bucket: int = 16,
    per_bucket_cap: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially-spread top-k: each ``bucket`` px bucket keeps at most
    ``per_bucket_cap`` strongest responses, then a global top-``n_keep``.

    Returns (xy int32 (n_keep, 2) as (x, y), response (n_keep,),
    valid bool (n_keep,)).
    """
    h, w = score.shape
    hc = -(-h // bucket)
    wc = -(-w // bucket)
    padded = F.pad(score, (0, wc * bucket - w, 0, hc * bucket - h))
    flat_blocks = (padded.reshape(hc, bucket, wc, bucket)
                   .permute(0, 2, 1, 3).reshape(hc * wc, bucket * bucket))
    kth = topk_stable(flat_blocks, per_bucket_cap)[0][:, -1]
    capped = torch.where(
        flat_blocks >= torch.clamp(kth, min=1e-6)[:, None], flat_blocks,
        torch.zeros_like(flat_blocks),
    )
    capped_img = (
        capped.reshape(hc, wc, bucket, bucket)
        .permute(0, 2, 1, 3)
        .reshape(hc * bucket, wc * bucket)[:h, :w]
    )
    vals, idx = topk_stable(capped_img.reshape(-1), n_keep)
    ys = idx // w
    xs = idx % w
    valid = vals > 0.0
    xy = torch.stack([xs, ys], dim=-1).to(torch.int32)
    return xy, vals, valid
