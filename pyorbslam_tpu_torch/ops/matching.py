"""Batched projection matcher, frustum gate and rotation histogram.

Port of the per-frame parts of ``pyorbslam_tpu/ops/matching.py``:

* :func:`project_points` + :func:`frustum_gate` replace
  Frame.is_in_frustum (Frame.py:328-371) for whole landmark blocks;
* :func:`match_by_projection` is the shared core of
  ORBMatcher.search_by_projection_f_f and search_by_projection_f_p
  (ORBMatcher.py:215-393): the grid query becomes a |dx|,|dy| < r mask
  over the full Q x N Hamming matrix, and conflicts keep the lowest
  distance per target feature;
* :func:`rotation_consistency_mask` is the 30-bin rotation histogram
  top-3 filter (ORBMatcher.py:16-19), with upstream's 0.1x cutoff.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pyorbslam_tpu_torch.ops import hamming as ham
from pyorbslam_tpu_torch.ops.fast import topk_stable

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
BIG = 1_000_000


class Projection(NamedTuple):
    u: torch.Tensor         # (Q,) projected column
    v: torch.Tensor         # (Q,) projected row
    ur: torch.Tensor        # (Q,) projected right-view column u - bf/z
    depth: torch.Tensor     # (Q,) camera-frame z
    dist: torch.Tensor      # (Q,) distance to camera center
    in_image: torch.Tensor  # (Q,) bool: z > 0 and inside bounds


def project_points(
    Tcw: torch.Tensor, pts_w: torch.Tensor, cam: torch.Tensor,
    bounds: torch.Tensor,
) -> Projection:
    """cam = [fx, fy, cx, cy, bf]; bounds = [min_x, max_x, min_y, max_y]."""
    Pc = pts_w @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = Pc[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    invz = 1.0 / safe_z
    u = cam[0] * Pc[:, 0] * invz + cam[2]
    v = cam[1] * Pc[:, 1] * invz + cam[3]
    ur = u - cam[4] * invz
    Ow = se3_center(Tcw)
    dist = torch.linalg.norm(pts_w - Ow, dim=-1)
    in_image = (
        (z > 0.0)
        & (u >= bounds[0]) & (u <= bounds[1])
        & (v >= bounds[2]) & (v <= bounds[3])
    )
    return Projection(u=u, v=v, ur=ur, depth=z, dist=dist, in_image=in_image)


def se3_center(Tcw: torch.Tensor) -> torch.Tensor:
    return -Tcw[:3, :3].T @ Tcw[:3, 3]


def predict_scale(
    dist: torch.Tensor, max_dist: torch.Tensor, log_scale_factor: float,
    n_levels: int,
) -> torch.Tensor:
    """MapPoint.predict_scale (MapPoint.py:294-302): ceil(log(maxDist/d)/log(s))."""
    ratio = torch.clamp(max_dist / torch.clamp(dist, min=1e-6), min=1e-6)
    level = torch.ceil(torch.log(ratio) / log_scale_factor).to(torch.int32)
    return torch.clamp(level, 0, n_levels - 1)


def frustum_gate(
    proj: Projection,
    normals: torch.Tensor,      # (Q, 3) mean viewing directions
    min_dist: torch.Tensor,     # (Q,) 0.8 * min scale-invariance distance
    max_dist: torch.Tensor,     # (Q,) 1.2 * max
    pts_w: torch.Tensor,
    Ow: torch.Tensor,
    viewing_cos_limit: float = 0.5,
) -> torch.Tensor:
    """Frame.is_in_frustum gates: image bounds, distance band, view angle."""
    po = pts_w - Ow
    view_cos = torch.einsum("qi,qi->q", po, normals) / torch.clamp(proj.dist, min=1e-6)
    return (
        proj.in_image
        & (proj.dist >= min_dist)
        & (proj.dist <= max_dist)
        & (view_cos >= viewing_cos_limit)
    )


def match_by_projection(
    # queries (Q):
    q_u: torch.Tensor, q_v: torch.Tensor, q_ur: torch.Tensor,
    q_desc_bits: torch.Tensor,  # (Q, 256) int8
    q_pop: torch.Tensor,        # (Q,) popcounts
    q_radius: torch.Tensor,     # (Q,) search radius in px
    q_min_level: torch.Tensor,  # (Q,) int32 inclusive
    q_max_level: torch.Tensor,  # (Q,) int32 inclusive (large value = open)
    q_active: torch.Tensor,     # (Q,) bool
    # frame features (N):
    f_xy: torch.Tensor, f_octave: torch.Tensor, f_u_right: torch.Tensor,
    f_desc_bits: torch.Tensor, f_pop: torch.Tensor,
    f_free: torch.Tensor,       # (N,) bool: feature may accept a match
    max_dist_th: int = TH_HIGH,
    ratio: Optional[float] = None,   # mfNNratio second-best test (f_p only)
    stereo_gate: bool = True,
    dist: Optional[torch.Tensor] = None,  # precomputed (Q, N) Hamming matrix
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (match_idx (Q,) int32 [-1 = none], match_dist (Q,), matched (Q,) bool).

    Conflicts (two queries matching one feature) keep the lower distance;
    ties go to the lower query index.  Pass ``dist`` to reuse one Hamming
    matrix across several radius tiers.
    """
    if dist is None:
        dist = ham.hamming_matrix_bits(q_desc_bits, q_pop, f_desc_bits, f_pop)

    dx = torch.abs(f_xy[None, :, 0] - q_u[:, None])
    dy = torch.abs(f_xy[None, :, 1] - q_v[:, None])
    window = (dx < q_radius[:, None]) & (dy < q_radius[:, None])
    level_ok = (f_octave[None, :] >= q_min_level[:, None]) & (
        f_octave[None, :] <= q_max_level[:, None]
    )
    mask = window & level_ok & f_free[None, :] & q_active[:, None]
    if stereo_gate:
        er = torch.abs(q_ur[:, None] - f_u_right[None, :])
        mask &= (f_u_right[None, :] <= 0) | (er <= q_radius[:, None])

    dist = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_idx = torch.argmin(dist, dim=1)
    best = torch.gather(dist, 1, best_idx[:, None])[:, 0]
    matched = best <= max_dist_th

    if ratio is not None:
        cols = torch.arange(dist.shape[1], device=dist.device)
        dist2 = torch.where(cols[None, :] == best_idx[:, None],
                            torch.full_like(dist, BIG), dist)
        second_idx = torch.argmin(dist2, dim=1)
        second = torch.gather(dist2, 1, second_idx[:, None])[:, 0]
        same_level = f_octave[best_idx] == f_octave[second_idx]
        # the reference skips only when best_level == best_level2 and the
        # ratio test fails (ORBMatcher.py:276-279)
        fail = same_level & (best.to(torch.float32) > ratio * second.to(torch.float32)) \
            & (second < BIG)
        matched &= ~fail

    # conflict resolution: keep the lowest distance per target feature
    # (jax.ops.segment_min as scatter_reduce "amin" over a BIG-filled
    # buffer; only segments that received a query are read back)
    n = f_xy.shape[0]
    eff_dist = torch.where(matched, best, torch.full_like(best, BIG))
    per_target_best = torch.full((n,), BIG, dtype=eff_dist.dtype,
                                 device=dist.device).scatter_reduce(
        0, best_idx, eff_dist, "amin", include_self=True)
    q_arange = torch.arange(best.shape[0], dtype=torch.int64, device=dist.device)
    cand = torch.where(eff_dist == per_target_best[best_idx], q_arange,
                       torch.full_like(q_arange, BIG))
    winner_q = torch.full((n,), BIG, dtype=torch.int64,
                          device=dist.device).scatter_reduce(
        0, best_idx, cand, "amin", include_self=True)
    matched &= winner_q[best_idx] == q_arange

    match_idx = torch.where(matched, best_idx, torch.full_like(best_idx, -1))
    return match_idx.to(torch.int32), best, matched


def rotation_consistency_mask(
    q_angle: torch.Tensor, f_angle: torch.Tensor, match_idx: torch.Tensor,
    matched: torch.Tensor, apply_ratio_cut: bool = True,
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the top-3 bins of
    a 30-bin rotation histogram (ties between bins: lower bin first)."""
    rot = q_angle - f_angle[match_idx.long()]
    rot = torch.where(rot < 0, rot + 360.0, rot)
    bins = torch.round(rot * (HISTO_LENGTH / 360.0)).long()
    bins = torch.where(bins == HISTO_LENGTH, torch.zeros_like(bins), bins)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32,
                         device=rot.device).index_add_(0, bins, matched.to(torch.int32))
    top3_counts, top3 = topk_stable(counts, 3)
    keep_top3 = torch.ones(3, dtype=torch.bool, device=rot.device)
    if apply_ratio_cut:
        # upstream ORB-SLAM2: bins 2/3 kept only if > 0.1 * max
        keep_top3[1:] = top3_counts[1:] > 0.1 * top3_counts[0]
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool,
                           device=rot.device).scatter_(0, top3, keep_top3)
    return matched & keep_bin[bins]
