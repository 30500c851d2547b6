"""Batched projection matcher, frustum gate and rotation histogram.

Port of the per-frame parts of ``pyorbslam_tpu/ops/matching.py``:

* :func:`project_points` + :func:`frustum_gate` replace
  Frame.is_in_frustum (Frame.py:328-371) for whole landmark blocks;
* :func:`match_by_projection` is the shared core of
  ORBMatcher.search_by_projection_f_f and search_by_projection_f_p
  (ORBMatcher.py:215-393): the grid query becomes a |dx|,|dy| < r mask
  over the full Q x N Hamming matrix, and conflicts keep the lowest
  distance per target feature;
* :func:`match_by_bow` is ORBMatcher.search_by_BoW_kf_f
  (ORBMatcher.py:21-118): the vocabulary-node buckets become an equality
  mask over the full Hamming matrix; :func:`bow_match` and
  :func:`bow_match_rot` are the relocalization and reference-keyframe
  matchers built on it;
* :func:`rotation_consistency_mask` is the 30-bin rotation histogram
  top-3 filter (ORBMatcher.py:16-19), with upstream's 0.1x cutoff;
* :func:`sim3_mutual_match` is ORBMatcher.search_by_sim3
  (ORBMatcher.py:713-848), the loop closer's mutual Sim3 projection
  matcher.
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
    eff_dist = torch.where(matched, best, torch.full_like(best, BIG))
    matched &= _one_query_per_target(best_idx, eff_dist, f_xy.shape[0])

    match_idx = torch.where(matched, best_idx, torch.full_like(best_idx, -1))
    return match_idx.to(torch.int32), best, matched


def _one_query_per_target(best_idx: torch.Tensor, eff_dist: torch.Tensor,
                          n_targets: int) -> torch.Tensor:
    """(Q,) bool: query q holds the lowest ``eff_dist`` among the queries
    whose best target is ``best_idx[q]``; ties go to the lower query index.
    The JAX package's two ``segment_min``s, as ``scatter_reduce("amin")``
    into buffers filled with BIG and ``include_self=True``: every value is
    at most BIG, so a segment's result is the minimum of what it received,
    and a segment that received nothing is never read back."""
    dev = best_idx.device
    per_target = torch.full((n_targets,), BIG, dtype=eff_dist.dtype,
                            device=dev).scatter_reduce(
        0, best_idx, eff_dist, "amin", include_self=True)
    q_arange = torch.arange(best_idx.shape[0], dtype=torch.int64, device=dev)
    cand = torch.where(eff_dist == per_target[best_idx], q_arange,
                       torch.full_like(q_arange, BIG))
    winner = torch.full((n_targets,), BIG, dtype=torch.int64,
                        device=dev).scatter_reduce(
        0, best_idx, cand, "amin", include_self=True)
    return winner[best_idx] == q_arange


def match_by_bow(
    q_desc_bits: torch.Tensor,  # (Q, 256) int8  (keyframe side)
    q_pop: torch.Tensor,
    q_node: torch.Tensor,       # (Q,) int32 vocabulary node at level L-4
    q_active: torch.Tensor,     # (Q,) bool
    f_desc_bits: torch.Tensor,  # (N, 256) frame side
    f_pop: torch.Tensor,
    f_node: torch.Tensor,       # (N,)
    f_active: torch.Tensor,
    ratio: float = 0.7,
    max_dist_th: int = TH_LOW,
    node_gate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BoW-guided matching (ORBMatcher.search_by_BoW_kf_f:21-118): only
    descriptor pairs sharing a vocabulary node are compared, with the
    best/second-best ratio test at TH_LOW.  The node-bucket iteration of
    the reference becomes an equality mask over the full distance matrix;
    ``node_gate=False`` drops the bucket constraint (the buckets prune a
    CPU search, they are not semantics).

    Among equal distances the lowest feature index is the best match
    (``jnp.argmin``'s first occurrence, made explicit as the minimum of
    ``dist * N + column``), and of two queries on one feature the lower
    distance, then the lower query index, keeps it.

    Returns (match_idx (Q,) int32 [-1 = none], dist (Q,), matched (Q,))."""
    dist = ham.hamming_matrix_bits(q_desc_bits, q_pop, f_desc_bits, f_pop)
    mask = q_active[:, None] & f_active[None, :]
    if node_gate:
        mask = mask & (q_node[:, None] == f_node[None, :])
    n = f_desc_bits.shape[0]
    dist = torch.where(mask, dist, torch.full_like(dist, BIG)).to(torch.int64)
    cols = torch.arange(n, dtype=torch.int64, device=dist.device)
    key = dist * n + cols[None, :]
    best_key = key.min(dim=1).values
    best_idx = best_key % n
    best = best_key // n
    dist2 = torch.where(cols[None, :] == best_idx[:, None],
                        torch.full_like(dist, BIG), dist)
    second = dist2.min(dim=1).values
    matched = (best <= max_dist_th) & (
        best.to(torch.float32) < ratio * second.to(torch.float32))

    # one query per target feature (keep the lowest distance)
    eff = torch.where(matched, best, torch.full_like(best, BIG))
    matched = matched & _one_query_per_target(best_idx, eff, n)
    match_idx = torch.where(matched, best_idx, torch.full_like(best_idx, -1))
    return match_idx.to(torch.int32), best.to(torch.int32), matched


def bow_match(kf_desc, kf_node, q_active, f_bits, f_pop, f_node, f_valid):
    """search_by_BoW from a keyframe's packed descriptors: the
    relocalization candidate matcher."""
    return match_by_bow(
        ham.unpack_bits(kf_desc), ham.popcount(kf_desc), kf_node, q_active,
        f_bits, f_pop, f_node, f_valid)


def bow_match_rot(kf_desc, kf_node, q_active, f_bits, f_pop, f_node, f_valid,
                  kf_angle, f_angle):
    """search_by_BoW + rotation consistency: the reference-keyframe
    fallback matcher (Tracking.py:329-356).  Returns (idx, matched)."""
    idx, _, matched = bow_match(
        kf_desc, kf_node, q_active, f_bits, f_pop, f_node, f_valid)
    matched = rotation_consistency_mask(
        kf_angle, f_angle, torch.clamp(idx, min=0), matched)
    return idx, matched


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


def sim3_mutual_match(
    # KF1 (current) side: landmark geometry per feature slot
    p1_pos: torch.Tensor,       # (N1, 3) world pos of slot's landmark
    p1_desc_bits: torch.Tensor, p1_pop: torch.Tensor,
    p1_has: torch.Tensor,       # (N1,) bool slot carries a live landmark
    p1_dmin: torch.Tensor, p1_dmax: torch.Tensor,
    already1: torch.Tensor,     # (N1,) bool already matched (skip)
    f1_xy: torch.Tensor, f1_octave: torch.Tensor,
    f1_desc_bits: torch.Tensor, f1_pop: torch.Tensor, f1_valid: torch.Tensor,
    # KF2 (loop candidate) side
    p2_pos: torch.Tensor, p2_desc_bits: torch.Tensor, p2_pop: torch.Tensor,
    p2_has: torch.Tensor, p2_dmin: torch.Tensor, p2_dmax: torch.Tensor,
    already2: torch.Tensor,
    f2_xy: torch.Tensor, f2_octave: torch.Tensor,
    f2_desc_bits: torch.Tensor, f2_pop: torch.Tensor, f2_valid: torch.Tensor,
    # geometry
    T1w: torch.Tensor, T2w: torch.Tensor,        # (4, 4) KF poses
    R12: torch.Tensor, t12: torch.Tensor, s12: torch.Tensor,  # Sim3 cam2->cam1
    cam4: torch.Tensor,         # [fx, fy, cx, cy]
    bounds: torch.Tensor,       # [min_x, max_x, min_y, max_y]
    scale_factors: torch.Tensor,
    log_scale_factor: float, n_levels: int,
    th: float = 7.5,
) -> torch.Tensor:
    """ORBMatcher.search_by_sim3 (ORBMatcher.py:713-848): grow loop
    correspondences by projecting each keyframe's landmarks into the
    other with the candidate Sim3, keeping only MUTUALLY consistent
    pairs.  Radius th * scale[predicted level], level window
    [pred-1, pred], TH_HIGH cut, distance-invariance band gate.

    Returns (N1,) int32: KF2 feature index per KF1 feature slot (-1)."""

    def direction(p_pos, p_bits, p_pop, p_has, p_dmin, p_dmax, already,
                  Tsw, to_other, f_xy, f_oct, f_bits, f_pop, f_valid):
        Pc = to_other(p_pos @ Tsw[:3, :3].T + Tsw[:3, 3])
        z = Pc[:, 2]
        invz = 1.0 / torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        u = cam4[0] * Pc[:, 0] * invz + cam4[2]
        v = cam4[1] * Pc[:, 1] * invz + cam4[3]
        in_img = (z > 0) & (u >= bounds[0]) & (u <= bounds[1]) \
            & (v >= bounds[2]) & (v <= bounds[3])
        dist = torch.linalg.norm(Pc, dim=-1)
        pred = predict_scale(dist, p_dmax / 1.2, log_scale_factor, n_levels)
        radius = th * scale_factors[pred.long()]
        active = p_has & ~already & in_img & (dist >= p_dmin) & (dist <= p_dmax)
        idx, _, matched = match_by_projection(
            u, v, torch.full_like(u, -1.0), p_bits, p_pop, radius,
            pred - 1, pred, active,
            f_xy, f_oct, torch.full_like(f_xy[:, 0], -1.0),
            f_bits, f_pop, f_valid,
            max_dist_th=TH_HIGH, ratio=None, stereo_gate=False,
        )
        return torch.where(matched, idx, torch.full_like(idx, -1))

    # cam2 = (1/s) R12^T (cam1 - t12);  cam1 = s R12 cam2 + t12
    m12 = direction(
        p1_pos, p1_desc_bits, p1_pop, p1_has, p1_dmin, p1_dmax, already1,
        T1w, lambda P: ((P - t12) @ R12) / s12,
        f2_xy, f2_octave, f2_desc_bits, f2_pop, f2_valid,
    )
    m21 = direction(
        p2_pos, p2_desc_bits, p2_pop, p2_has, p2_dmin, p2_dmax, already2,
        T2w, lambda P: (P @ R12.T) * s12 + t12,
        f1_xy, f1_octave, f1_desc_bits, f1_pop, f1_valid,
    )
    i1 = torch.arange(m12.shape[0], dtype=torch.int32, device=m12.device)
    mutual = (m12 >= 0) & (m21[torch.clamp(m12, min=0).long()] == i1)
    return torch.where(mutual, m12, torch.full_like(m12, -1))
