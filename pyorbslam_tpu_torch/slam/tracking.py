"""Frame-to-frame tracking: motion model + projection matching + pose LM.

Port of the per-frame parts of ``pyorbslam_tpu/slam/tracking.py``.

The device side is plain functions on tensors: :func:`motion_track_step`
(Tracking.track_with_motion_model, Tracking.py:578-616: project the last
frame's landmarks with the constant-velocity prediction, match by
projection at th=7 px, or 2*th when fewer than 20 match, rotation
histogram, 4x10 LM pose optimization, strip outliers),
:func:`local_track_step` (Tracking.track_local_map, Tracking.py:358-468),
and their fused form on a built frame, :func:`fused_retrack_step`, which
gathers landmark blocks from a device-resident mirror by index and is
the one producer of a tracked frame's row; :func:`read_row` is its one
decoder.  Every schedule runs it: :func:`fused_track_chain_step` (frame
build + the core), :func:`fused_track_window` (W frames chained on the
device) and the re-track of a scanned frame.  :func:`kf_snapshot` and its
decoder :func:`read_snapshot` carry keyframe insertion's one read.  The
``n_matches < 20`` style decisions are ``torch.where`` on the device, so
a step reads nothing back to the host until its caller does.  On a card
the core and the snapshot replay from CUDA graphs, one per key
(``TRACK_STEP``, ``KF_SNAPSHOT``; ``utils/cuda_graph.py``).

The host side, :class:`Tracker`, owns the landmark store and the
bookkeeping of Tracking.py's state machine: stereo initialization
(Tracking.py:282-319), velocity update (Tracking.py:224-232) and
landmark creation by depth order (create_new_key_frame,
Tracking.py:523-576).  It is a complete stereo visual odometry, the
tracking-only configuration.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from pyorbslam_tpu_torch.config import SlamConfig
from pyorbslam_tpu_torch.geometry import se3
from pyorbslam_tpu_torch.ops import hamming as ham
from pyorbslam_tpu_torch.ops import matching as match_ops
from pyorbslam_tpu_torch.ops.orb_descriptor import to_int32_bits
from pyorbslam_tpu_torch.optim import pose_opt
from pyorbslam_tpu_torch.slam.frame import (
    StereoFrame, build_stereo_frame, pack_frame, unpack_frame_np, unproject)
from pyorbslam_tpu_torch.slam.mapstore import LandmarkStore
from pyorbslam_tpu_torch.utils import trace
from pyorbslam_tpu_torch.utils.cuda_graph import GraphedProgram
from pyorbslam_tpu_torch.utils.host_read import device_constant, upload
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls


class TrackStepResult(NamedTuple):
    Tcw: torch.Tensor          # (4, 4) optimized pose
    feat_query: torch.Tensor   # (N,) int32: matched query slot per feature (-1)
    tracked: torch.Tensor      # (N,) bool: feature holds a surviving match
    inlier_edge: torch.Tensor  # (N,) bool: stereo edge survived chi2 gating
    n_matches: torch.Tensor    # () int32 matches after rotation check
    n_inliers: torch.Tensor    # () int32 pose-opt stereo inliers


class LocalTrackResult(NamedTuple):
    Tcw: torch.Tensor
    feat_local: torch.Tensor   # (N,) int32: local-point slot newly matched (-1)
    tracked: torch.Tensor      # (N,) bool: any assignment surviving pose opt
    inlier_edge: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor    # () int32 (mnMatchesInliers analog)
    p_visible: torch.Tensor    # (P,) bool: local point passed the frustum gate


class _Consts(NamedTuple):
    cam: torch.Tensor            # [fx, fy, cx, cy, bf]
    bounds: torch.Tensor         # [min_x, max_x, min_y, max_y]
    scale_factors: torch.Tensor  # (L,)
    inv_sigma2: torch.Tensor     # (L,)


@lru_cache(maxsize=8)
def _consts(cfg: SlamConfig, device: torch.device) -> _Consts:
    c = cfg.camera

    def f32(x):
        return device_constant(np.asarray(x, np.float32), torch.float32, device)

    return _Consts(
        cam=f32([c.fx, c.fy, c.cx, c.cy, c.bf]),
        bounds=f32([0.0, c.width - 1.0, 0.0, c.height - 1.0]),
        scale_factors=f32(cfg.orb.scale_factors),
        inv_sigma2=f32(cfg.orb.inv_level_sigma2),
    )


def _scatter_slots(n_feat: int, matched: torch.Tensor, idx: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """(n_feat,) int32 map feature -> ids[q] for matched q (-1 elsewhere).
    Non-matches land in an extra dump slot past the end; winners are
    unique per feature, so no slot that is read gets two writes."""
    scatter_to = torch.where(matched, idx.long(), torch.full_like(idx.long(), n_feat))
    out = torch.full((n_feat + 1,), -1, dtype=torch.int32, device=idx.device)
    out.index_put_((scatter_to,), ids.to(torch.int32))
    return out[:n_feat]


@trace.spanned("track.motion")
def motion_track_step(
    frame: StereoFrame,
    q_pos: torch.Tensor,        # (Q, 3) landmark world positions (per last-frame slot)
    q_desc: torch.Tensor,       # (Q, 8) packed landmark descriptors
    q_angle: torch.Tensor,      # (Q,) last-frame keypoint angle
    q_octave: torch.Tensor,     # (Q,) last-frame keypoint octave
    q_active: torch.Tensor,     # (Q,) bool: slot carries a live landmark
    Tcw_pred: torch.Tensor,     # (4, 4) velocity-model prediction
    Tlw: torch.Tensor,          # (4, 4) last frame pose (for fwd/bwd octave logic)
    cfg: SlamConfig,
    th_base: float = 7.0,       # search radius tier
) -> TrackStepResult:
    dev = frame.xy.device
    k = _consts(cfg, dev)
    n_levels = cfg.orb.n_levels
    q_octave = q_octave.to(torch.int32)

    proj = match_ops.project_points(Tcw_pred, q_pos, k.cam, k.bounds)

    # forward/backward octave window (ORBMatcher.py:305-352)
    twc = -Tcw_pred[:3, :3].T @ Tcw_pred[:3, 3]
    tlc = Tlw[:3, :3] @ twc + Tlw[:3, 3]
    baseline = cfg.camera.baseline
    fwd = tlc[2] > baseline
    bwd = -tlc[2] > baseline
    min_lev = torch.where(fwd, q_octave,
                          torch.where(bwd, torch.zeros_like(q_octave), q_octave - 1))
    max_lev = torch.where(fwd, torch.full_like(q_octave, n_levels - 1),
                          torch.where(bwd, q_octave, q_octave + 1))

    q_bits = ham.unpack_bits(q_desc)
    q_pop = ham.popcount(q_desc)
    f_pop = ham.popcount(frame.desc)
    active = q_active & proj.in_image
    f_free = frame.valid
    # one Hamming matrix shared by both radius tiers
    dist_qf = ham.hamming_matrix_bits(q_bits, q_pop, frame.desc_bits, f_pop)
    q_radius_unit = k.scale_factors[q_octave.long()]

    def run(th):
        idx, _, matched = match_ops.match_by_projection(
            proj.u, proj.v, proj.ur, q_bits, q_pop, th * q_radius_unit,
            min_lev, max_lev, active,
            frame.xy, frame.octave, frame.u_right, frame.desc_bits, f_pop,
            f_free, max_dist_th=match_ops.TH_HIGH, ratio=None, stereo_gate=True,
            dist=dist_qf,
        )
        matched = match_ops.rotation_consistency_mask(
            q_angle, frame.angle, torch.clamp(idx, min=0), matched
        )
        return idx, matched

    idx1, m1 = run(th_base)
    n1 = torch.sum(m1.to(torch.int32))
    idx2, m2 = run(2.0 * th_base)
    use_wide = n1 < 20
    idx = torch.where(use_wide, idx2, idx1)
    matched = torch.where(use_wide, m2, m1)
    n_matches = torch.sum(matched.to(torch.int32)).to(torch.int32)

    n_feat = frame.capacity
    q_ids = torch.arange(q_pos.shape[0], dtype=torch.int32, device=dev)
    feat_query = _scatter_slots(n_feat, matched, idx, q_ids)

    has_point = feat_query >= 0
    Xw = q_pos[torch.clamp(feat_query, min=0).long()]
    obs = torch.stack([frame.xy[:, 0], frame.xy[:, 1], frame.u_right], dim=-1)
    inv_sigma2 = k.inv_sigma2[frame.octave.long()]
    edge_active = has_point & (frame.u_right > 0) & frame.valid

    result = pose_opt.pose_optimization(
        Tcw_pred, Xw, obs, inv_sigma2, edge_active, k.cam,
        rounds=cfg.ba.pose_rounds, iters=cfg.ba.pose_iters_per_round,
    )

    # outlier assignments are dropped (Tracking.py:601-608); matches
    # without a stereo edge survive on the matcher's word alone
    tracked = has_point & torch.where(edge_active, result.inliers,
                                      torch.ones_like(edge_active))
    feat_query = torch.where(tracked, feat_query, torch.full_like(feat_query, -1))

    return TrackStepResult(
        Tcw=result.Tcw, feat_query=feat_query, tracked=tracked,
        inlier_edge=result.inliers, n_matches=n_matches,
        n_inliers=result.num_inliers,
    )


@trace.spanned("track.local")
def local_track_step(
    frame: StereoFrame,
    feat_xw: torch.Tensor,      # (N, 3) world pos for already-assigned features
    feat_has: torch.Tensor,     # (N,) bool feature already has a point
    p_pos: torch.Tensor,        # (P, 3) local map point positions
    p_desc: torch.Tensor,       # (P, 8)
    p_normal: torch.Tensor,     # (P, 3)
    p_dmin: torch.Tensor,       # (P,) 0.8 * min scale-invariance distance
    p_dmax: torch.Tensor,       # (P,) 1.2 * max
    p_active: torch.Tensor,     # (P,) bool (excludes already-assigned points)
    Tcw: torch.Tensor,          # (4, 4) pose after motion tracking
    cfg: SlamConfig,
    radius_mult: Optional[float] = None,
    max_dist_th: Optional[int] = None,
) -> LocalTrackResult:
    """Tracking.track_local_map (Tracking.py:358-468): frustum-gate the
    local point set, match by projection with the viewing-cos radius and
    0.8 ratio test, then re-run pose optimization over the union of
    assignments.  With ``radius_mult``/``max_dist_th`` set it is the
    relocalization projection rescue instead (ORBMatcher.py:924-1008)."""
    dev = frame.xy.device
    k = _consts(cfg, dev)
    orb = cfg.orb

    proj = match_ops.project_points(Tcw, p_pos, k.cam, k.bounds)
    Ow = match_ops.se3_center(Tcw)
    in_frustum = match_ops.frustum_gate(
        proj, p_normal, p_dmin, p_dmax, p_pos, Ow, viewing_cos_limit=0.5
    )
    active = p_active & in_frustum

    # predicted level and radius (ORBMatcher.py:215-246, 285-289)
    max_dist = p_dmax / 1.2
    pred_level = match_ops.predict_scale(
        proj.dist, max_dist, float(np.log(orb.scale_factor)), orb.n_levels
    )
    po = p_pos - Ow
    view_cos = torch.einsum("pi,pi->p", po, p_normal) / torch.clamp(proj.dist, min=1e-6)
    if radius_mult is None:
        r = torch.where(view_cos > 0.998, torch.full_like(view_cos, 2.5),
                        torch.full_like(view_cos, 4.0))
        max_level = pred_level
        ratio = 0.8
    else:
        r = torch.full_like(view_cos, radius_mult)
        max_level = pred_level + 1
        ratio = None
    radius = r * k.scale_factors[pred_level.long()]

    p_bits = ham.unpack_bits(p_desc)
    p_pop = ham.popcount(p_desc)
    f_pop = ham.popcount(frame.desc)
    f_free = frame.valid & ~feat_has

    idx, _, matched = match_ops.match_by_projection(
        proj.u, proj.v, proj.ur, p_bits, p_pop, radius,
        pred_level - 1, max_level, active,
        frame.xy, frame.octave, frame.u_right, frame.desc_bits, f_pop,
        f_free,
        max_dist_th=(match_ops.TH_HIGH if max_dist_th is None else max_dist_th),
        ratio=ratio, stereo_gate=True,
    )

    n_feat = frame.capacity
    p_ids = torch.arange(p_pos.shape[0], dtype=torch.int32, device=dev)
    feat_local = _scatter_slots(n_feat, matched, idx, p_ids)

    has_local = feat_local >= 0
    Xw = torch.where(
        has_local[:, None], p_pos[torch.clamp(feat_local, min=0).long()], feat_xw
    )
    has_point = feat_has | has_local
    obs = torch.stack([frame.xy[:, 0], frame.xy[:, 1], frame.u_right], dim=-1)
    inv_sigma2 = k.inv_sigma2[frame.octave.long()]
    edge_active = has_point & (frame.u_right > 0) & frame.valid

    result = pose_opt.pose_optimization(
        Tcw, Xw, obs, inv_sigma2, edge_active, k.cam,
        rounds=cfg.ba.pose_rounds, iters=cfg.ba.pose_iters_per_round,
    )
    tracked = has_point & torch.where(edge_active, result.inliers,
                                      torch.ones_like(edge_active))
    feat_local = torch.where(tracked, feat_local, torch.full_like(feat_local, -1))
    n_inliers = torch.sum((tracked & edge_active).to(torch.int32)).to(torch.int32)
    return LocalTrackResult(
        Tcw=result.Tcw, feat_local=feat_local, tracked=tracked,
        inlier_edge=result.inliers, n_inliers=n_inliers, p_visible=active,
    )


def _bitpack_bool(x: torch.Tensor) -> torch.Tensor:
    """(P,) bool -> (P/32,) int32 little-endian bit words (P % 32 == 0)."""
    bits = x.to(torch.int64).reshape(-1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return to_int32_bits((bits << shifts[None, :]).sum(dim=1))


def unpack_bool_np(words: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of :func:`_bitpack_bool` -> (n,) bool."""
    return np.unpackbits(
        words.view(np.uint8), bitorder="little")[:n].astype(bool)


# the fields of the two frames the tracking step reads: the new frame's
# all but ``response``, the previous frame's those its motion queries take
STEP_FIELDS = ("xy", "angle", "octave", "desc", "desc_bits", "valid",
               "u_right", "depth")
PREV_FIELDS = ("xy", "angle", "octave", "desc", "valid", "depth")
# the fields of a frame the keyframe snapshot reads
SNAPSHOT_FIELDS = ("xy", "angle", "u_right", "depth", "response", "octave",
                   "valid", "desc")

# the tracking step's and the keyframe snapshot's graphs, for the life of
# the process
TRACK_STEP = GraphedProgram("track.step_capture")
KF_SNAPSHOT = GraphedProgram("track.snapshot_capture")


def _fields(frame: StereoFrame, names: tuple) -> tuple:
    return tuple(getattr(frame, f) for f in names)


def _frame_of(names: tuple, tensors) -> StereoFrame:
    """A :class:`StereoFrame` holding ``tensors`` as the fields ``names``,
    None in the fields a body does not read."""
    given = dict(zip(names, tensors))
    return StereoFrame(*(given.get(f) for f in StereoFrame._fields))


def step_settings(cfg: SlamConfig) -> tuple:
    """Every setting :func:`track_step_body` reads, for its graph key: the
    camera's intrinsics, image size and ThDepth, the pyramid's scale
    factor and levels, the pose optimizer's rounds and iterations."""
    c, o, b = cfg.camera, cfg.orb, cfg.ba
    return (c.fx, c.fy, c.cx, c.cy, c.bf, c.width, c.height, c.th_depth,
            o.scale_factor, o.n_levels, b.pose_rounds, b.pose_iters_per_round)


def decode_row(row: torch.Tensor, n_feat: int):
    """(Tcw (4, 4) float32, assign (N,) int32) of a row on its device:
    views of it, so they live as long as the row does."""
    return row[5:21].view(torch.float32).reshape(4, 4), row[21:21 + n_feat]


def fused_retrack_step(
    frame: StereoFrame,
    m_pos: torch.Tensor,        # (M, 3)  device-resident landmark mirror
    m_desc: torch.Tensor,       # (M, 8)
    m_normal: torch.Tensor,     # (M, 3)
    m_dmin: torch.Tensor,       # (M,)
    m_dmax: torch.Tensor,       # (M,)
    m_alive: torch.Tensor,      # (M,) bool
    q_lm,                       # (N,) landmark id per previous-frame feature
    frame_prev: StereoFrame,    # previous frame's features (device)
    p_ids,                      # (P,) local-map landmark ids (-1 pad)
    Tcw_pred,                   # (4, 4) velocity prediction
    Tlw,                        # (4, 4) previous frame pose
    cfg: SlamConfig,
    th_base: float = 7.0,
):
    """The tracking core on a built frame, the one producer of a tracked
    frame's row: motion-model + local-map tracking + pose optimization,
    gathering landmark blocks from the device-resident mirror by index
    (Tracking.track, Tracking.py:148-280).  Every schedule runs it: the
    per-frame step after its frame build (:func:`fused_track_chain_step`),
    each step of :func:`fused_track_window`, and the re-track of a scanned
    frame against the current map without a second ORB extraction.

    The body is :func:`track_step_body`; on a card it replays from a CUDA
    graph per key (``TRACK_STEP``: the inputs' shapes, which hold the
    feature capacity N, the mirror's M and the local bucket P, and
    :func:`step_settings` with ``th_base``).  ``q_lm``, ``p_ids``,
    ``Tcw_pred`` and ``Tlw`` may be host arrays, which go up through
    pinned memory.  A ``track.step`` span whose ``graph`` is 1 when the
    call replayed, 0 when it ran the body; a capture opens
    ``track.step_capture`` with ``features``, ``mirror``, ``local`` and
    ``th``.

    Returns (row, Tcw, assign): the row
    [stats 5 | Tcw f32 bits 16 | assign N | p_visible P/32 bit words]
    (:func:`read_row` decodes it on the host) and its Tcw and assign
    (:func:`decode_row`).  A replay's row is the graph's own tensor: the
    next call of the step may overwrite it, so a caller copies it out
    (``HostRead``, ``clone``) before calling again.
    """
    n = frame.capacity
    with trace.span("track.step") as sp:
        row, replayed = TRACK_STEP(
            partial(track_step_body, cfg=cfg, th_base=th_base),
            (*_fields(frame, STEP_FIELDS), m_pos, m_desc, m_normal, m_dmin,
             m_dmax, m_alive, q_lm, *_fields(frame_prev, PREV_FIELDS), p_ids,
             Tcw_pred, Tlw),
            frame.xy.device, settings=(step_settings(cfg), float(th_base)),
            counters=dict(features=n, mirror=m_pos.shape[0],
                          local=p_ids.shape[0], th=th_base))
        if sp is not None:
            sp.args["graph"] = int(replayed)
    return (row, *decode_row(row, n))


def track_step_body(*inputs: torch.Tensor, cfg: SlamConfig,
                    th_base: float) -> torch.Tensor:
    """:func:`fused_retrack_step`'s device work on its inputs in order:
    the frame's :data:`STEP_FIELDS`, the mirror's six blocks, ``q_lm``,
    the previous frame's :data:`PREV_FIELDS`, ``p_ids``, ``Tcw_pred``,
    ``Tlw``.  Returns the row.  No host read and no upload, so a CUDA
    graph can capture it.

    Motion-stage queries are hybrid: previous-frame slots backed by a live
    landmark use the mirror's position and descriptor; the rest chain
    visual odometry off the previous frame's stereo unprojection
    (Tracking.py:612-659's temporal VO points), which keeps motion
    tracking alive on a stale map.
    """
    n_f, n_p = len(STEP_FIELDS), len(PREV_FIELDS)
    frame = _frame_of(STEP_FIELDS, inputs[:n_f])
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive, q_lm = inputs[n_f:n_f + 7]
    frame_prev = _frame_of(PREV_FIELDS, inputs[n_f + 7:n_f + 7 + n_p])
    p_ids, Tcw_pred, Tlw = inputs[n_f + 7 + n_p:]

    q_lm = q_lm.long()
    safe_q = torch.clamp(q_lm, min=0)
    has_lm = (q_lm >= 0) & m_alive[safe_q]
    q_pos_vo = unproject(frame_prev, cfg, se3.inverse(Tlw))
    q_pos = torch.where(has_lm[:, None], m_pos[safe_q], q_pos_vo)
    q_desc = torch.where(has_lm[:, None], m_desc[safe_q], frame_prev.desc)
    q_active = has_lm | (frame_prev.valid & (frame_prev.depth > 0))
    res = motion_track_step(
        frame, q_pos, q_desc, frame_prev.angle, frame_prev.octave, q_active,
        Tcw_pred, Tlw, cfg, th_base,
    )
    # only landmark-backed matches produce map assignments; VO matches
    # still anchored the pose optimization above
    fq_safe = torch.clamp(res.feat_query, min=0).long()
    assign1 = torch.where((res.feat_query >= 0) & has_lm[fq_safe],
                          q_lm[fq_safe], torch.full_like(fq_safe, -1))
    ok_motion = res.n_matches >= 20
    Tcw_mid = torch.where(ok_motion, res.Tcw, Tcw_pred)

    feat_has = assign1 >= 0
    feat_xw = m_pos[torch.clamp(assign1, min=0)]
    p_ids = p_ids.long()
    safe_p = torch.clamp(p_ids, min=0)
    lres = local_track_step(
        frame, feat_xw, feat_has,
        m_pos[safe_p], m_desc[safe_p], m_normal[safe_p],
        m_dmin[safe_p], m_dmax[safe_p],
        (p_ids >= 0) & m_alive[safe_p],
        Tcw_mid, cfg,
    )
    assign_loc = torch.where(lres.feat_local >= 0,
                             p_ids[torch.clamp(lres.feat_local, min=0).long()],
                             assign1)
    assign_loc = torch.where(lres.tracked, assign_loc, torch.full_like(assign_loc, -1))

    # a local stage with too few anchors (stale map) must not overrule a
    # healthy motion/VO pose
    use_local = lres.n_inliers >= 10
    Tcw_fin = torch.where(use_local, lres.Tcw, Tcw_mid)
    assign = torch.where(use_local, assign_loc, assign1).to(torch.int32)

    depth = frame.depth
    close = (depth > 0) & (depth < cfg.camera.depth_threshold) & frame.valid
    tracked_close = torch.sum((close & (assign >= 0)).to(torch.int32))
    non_tracked_close = torch.sum((close & (assign < 0)).to(torch.int32))
    stats = torch.stack([
        res.n_matches, res.n_inliers, lres.n_inliers,
        tracked_close, non_tracked_close,
    ]).to(torch.int32)
    return torch.cat([
        stats,
        Tcw_fin.reshape(-1).contiguous().view(torch.int32),
        assign,
        _bitpack_bool(lres.p_visible),
    ])


class TrackRow(NamedTuple):
    """A tracked frame's row on the host (:func:`read_row`)."""
    n_matches: int             # motion-stage matches after the rotation check
    n_in_motion: int           # motion-stage pose-opt stereo inliers
    n_in_local: int            # local-map stage inliers (mnMatchesInliers)
    tracked_close: int         # close stereo features with a landmark
    non_tracked_close: int     # close stereo features without one
    Tcw: np.ndarray            # (4, 4) float32 pose
    assign: np.ndarray         # (N,) int32 landmark id per feature (-1 none)
    p_visible: np.ndarray      # (P,) bool: local point passed the frustum gate


def read_row(out: np.ndarray, n_feat: int, n_pts: int) -> TrackRow:
    """Host decoder of :func:`fused_retrack_step`'s row, read back as
    int32 (``n_feat`` features, ``n_pts`` local-map slots)."""
    n = 21 + n_feat
    return TrackRow(
        *(int(x) for x in out[:5]),
        out[5:21].copy().view(np.float32).reshape(4, 4),
        out[21:n], unpack_bool_np(out[n:n + n_pts // 32], n_pts))


def fused_track_chain_step(
    left: torch.Tensor, right: torch.Tensor,
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,   # landmark mirror
    frame_prev: StereoFrame,    # previous frame's features (device)
    q_lm,                       # (N,) landmark id per prev-frame feature
    Tcw_pred,                   # (4, 4) velocity-model prediction
    Tlw,                        # (4, 4) prev frame pose
    p_ids,                      # (P,) local-map ids (-1 pad)
    cfg: SlamConfig,
):
    """One frame of the per-frame schedules: the stereo frame build and
    :func:`fused_retrack_step` on it (``q_lm``, ``Tcw_pred``, ``Tlw`` and
    ``p_ids`` device tensors or host arrays).  The local point set
    ``p_ids`` is computed by the host from the previous frame, one frame
    staler than Tracking.update_local_points (Tracking.py:392-436).

    Returns (row, frame); the row is valid until the step's next call."""
    frame = build_stereo_frame(left, right, cfg)
    row, _, _ = fused_retrack_step(
        frame, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
        q_lm, frame_prev, p_ids, Tcw_pred, Tlw, cfg,
    )
    return row, frame


def fused_track_window(
    images: torch.Tensor,       # (W, 2, H, Wd) stereo pairs (u8 or f32)
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,   # landmark mirror
    last_frame: StereoFrame,    # previous frame's features (device)
    q_lm0: torch.Tensor,        # (N,) landmark id per last-frame feature
    p_ids: torch.Tensor,        # (P,) local-map ids, fixed for the window
    Tlw0: torch.Tensor,         # (4, 4) last frame pose
    Tllw0: torch.Tensor,        # (4, 4) pose before that (velocity seed)
    cfg: SlamConfig,
    first_frame: Optional[int] = None,
):
    """Track a window of W frames with no host involvement: a loop over
    the frames carries (previous features, landmark assignment, pose pair)
    on the device, each step the frame build and :func:`fused_retrack_step`
    with the constant-velocity prediction formed on the device.
    Each step is a ``window.step`` span with its frame's id, counted from
    ``first_frame`` (None: the open span's).

    The local map (mirror + ``p_ids``) is frozen for the window, as the
    reference's asynchronous LocalMapping leaves tracking on a lagging
    map; the host makes the keyframe decisions after the window from the
    rows.

    Returns (stacked rows (W, 21 + N + P/32), the W built frames, the
    final carry (frame, assign, Tcw, Tlw), on the device).
    """
    use_f32_matmuls()
    carry = (last_frame, q_lm0, Tlw0, Tllw0)
    rows, frames = [], []
    for k, lr in enumerate(images):
        with trace.span("window.step",
                        None if first_frame is None else first_frame + k):
            frame_prev, q_lm, Tlw, Tllw = carry
            frame = build_stereo_frame(lr[0], lr[1], cfg)
            vel = Tlw @ se3.inverse(Tllw)
            row, _, _ = fused_retrack_step(
                frame, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
                q_lm, frame_prev, p_ids, vel @ Tlw, Tlw, cfg,
            )
            # the next step's replay may overwrite a replay's row: the
            # window keeps a copy, and carries the pose and assignment
            # decoded from it
            row = row.clone()
            Tcw, assign = decode_row(row, frame.capacity)
            rows.append(row)
            frames.append(frame)
            carry = (frame, assign, Tcw, Tlw)
    return torch.stack(rows), frames, carry


def kf_snapshot(
    frame: StereoFrame, voc_arrays,
    voc_k: int, voc_L: int, voc_levels_up: int,
) -> torch.Tensor:
    """Everything keyframe insertion needs from a device-resident frame,
    in ONE packed read: the host feature snapshot (pack_frame) plus the
    BoW word/weight/node vectors from the vocabulary tree descent
    (Frame.compute_BoW, TemplatedVocabulary.transform:108-161).  Layout:
      [pack_frame 16N | word N | weight bits N | node N].
    The eager body of :func:`graphed_snapshot`: no host read and no
    upload."""
    from pyorbslam_tpu_torch.place.vocabulary import _transform_packed

    return torch.cat([
        pack_frame(frame),
        _transform_packed(frame.desc, *voc_arrays, voc_k, voc_L, voc_levels_up),
    ])


def _snapshot_body(*fields: torch.Tensor, voc_arrays, voc_k: int, voc_L: int,
                   voc_levels_up: int) -> torch.Tensor:
    return kf_snapshot(_frame_of(SNAPSHOT_FIELDS, fields), voc_arrays,
                       voc_k, voc_L, voc_levels_up)


def graphed_snapshot(
    frame: StereoFrame, voc_arrays,
    voc_k: int, voc_L: int, voc_levels_up: int,
):
    """(:func:`kf_snapshot`, replayed): on a card replayed from a CUDA
    graph per key (``KF_SNAPSHOT``: the shapes of the frame's
    :data:`SNAPSHOT_FIELDS`, the tree's k, L and levels up, and the
    addresses of the vocabulary's device arrays).  A graph reads those
    arrays by address, so they must live as long as the process
    (``Vocabulary._device_arrays`` hands out such constants).  A capture
    opens ``track.snapshot_capture`` with ``features``.  A replay's
    buffer is the graph's own tensor: the caller copies it out before
    calling again."""
    return KF_SNAPSHOT(
        partial(_snapshot_body, voc_arrays=voc_arrays, voc_k=voc_k,
                voc_L=voc_L, voc_levels_up=voc_levels_up),
        _fields(frame, SNAPSHOT_FIELDS), frame.xy.device,
        settings=(voc_k, voc_L, voc_levels_up,
                  tuple(a.data_ptr() for a in voc_arrays)),
        counters=dict(features=frame.capacity))


def read_snapshot(buf: np.ndarray, n: int):
    """Host decoder of :func:`kf_snapshot` for a frame of ``n`` features:
    (the frame's host arrays (``unpack_frame_np``), (word, weight, node))."""
    return unpack_frame_np(buf[: 16 * n], n), (
        buf[16 * n: 17 * n],
        buf[17 * n: 18 * n].view(np.float32),
        buf[18 * n: 19 * n],
    )


@dataclasses.dataclass
class Tracker:
    """Host orchestrator for the tracking-only (visual odometry) pipeline.
    Every device step runs on ``device``; nothing picks it for the caller."""

    cfg: SlamConfig
    device: torch.device
    landmark_capacity: int = 1 << 18
    local_window: int = 10        # recent KF groups forming the local map

    def __post_init__(self):
        use_f32_matmuls()
        self.device = torch.device(self.device)
        self.landmarks = LandmarkStore(self.landmark_capacity)
        self.state = "NOT_INITIALIZED"
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_frame: Optional[StereoFrame] = None
        self.last_assign: Optional[np.ndarray] = None  # (N,) landmark ids
        self.kf_groups: list = []  # landmark-id arrays per KF event (local map)
        self.frames_since_kf = 0
        self.frame_id = -1
        self.trajectory: list = []
        self.stats: list = []

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device through pinned memory: the upload
        does not wait for the work queued before it."""
        return upload(a, self.device)

    def _local_point_ids(self, exclude: np.ndarray) -> np.ndarray:
        """Local map = landmarks of recent KF groups minus already-assigned
        (update_local_points over observer keyframes, Tracking.py:424-436,
        with the recent-KF window standing in for the covisibility walk)."""
        cap = self.cfg.tracking.max_local_points
        groups = self.kf_groups[-self.local_window:]
        if not groups:
            return np.empty(0, np.int32)
        ids = np.unique(np.concatenate(groups))
        ids = self.landmarks.resolve(ids)
        ids = ids[(ids >= 0) & self.landmarks.alive[np.maximum(ids, 0)]]
        excl = exclude[exclude >= 0]
        if len(excl):
            ids = ids[~np.isin(ids, excl)]
        return ids[-cap:].astype(np.int32)

    # ---------------- public API ----------------

    def track(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> np.ndarray:
        """Process one stereo pair; returns the current Tcw estimate."""
        self.frame_id += 1
        frame = build_stereo_frame(self._dev(left), self._dev(right), self.cfg)
        if self.state == "NOT_INITIALIZED":
            self._stereo_initialization(frame)
        else:
            self._track_frame(frame, timestamp)
        self.trajectory.append(self.Tcw.copy())
        return self.Tcw

    # ---------------- internals ----------------

    def _stereo_initialization(self, frame: StereoFrame):
        n_valid = int(frame.valid.sum())
        if n_valid <= min(500, self.cfg.orb.n_features // 4):
            return  # wait for a richer frame (Tracking.py:284, scaled)
        self.Tcw = np.eye(4, dtype=np.float32)
        assign = self._create_landmarks(frame, self.Tcw, limit=None)
        self.kf_groups.append(np.unique(assign[assign >= 0]))
        self.last_frame = frame
        self.last_assign = assign
        self.velocity = np.eye(4, dtype=np.float32)
        self.frames_since_kf = 0
        self.state = "OK"

    def _track_frame(self, frame: StereoFrame, timestamp: float):
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        lm_ids = self.landmarks.resolve(self.last_assign)
        q_active = lm_ids >= 0
        safe = np.maximum(lm_ids, 0)

        res = motion_track_step(
            frame,
            self._dev(self.landmarks.pos[safe]),
            self._dev(self.landmarks.desc[safe]),
            self.last_frame.angle,
            self.last_frame.octave,
            self._dev(q_active),
            self._dev(Tcw_pred),
            self._dev(self.Tcw),
            self.cfg,
        )
        n_matches = int(res.n_matches)
        feat_query = res.feat_query.cpu().numpy()
        assign = np.where(feat_query >= 0, lm_ids[np.maximum(feat_query, 0)], -1)
        Tcw_mid = res.Tcw.cpu().numpy() if n_matches >= 20 else Tcw_pred

        # ---- second stage: local-map tracking ----
        local_ids = self._local_point_ids(exclude=assign)
        cap = self.cfg.tracking.max_local_points
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids
        p_safe = np.maximum(p_ids, 0)
        feat_has = assign >= 0
        feat_xw = self.landmarks.pos[np.maximum(assign, 0)]

        lres = local_track_step(
            frame,
            self._dev(feat_xw),
            self._dev(feat_has),
            self._dev(self.landmarks.pos[p_safe]),
            self._dev(self.landmarks.desc[p_safe]),
            self._dev(self.landmarks.normal[p_safe]),
            self._dev(self.landmarks.dmin[p_safe]),
            self._dev(self.landmarks.dmax[p_safe]),
            self._dev(p_ids >= 0),
            self._dev(Tcw_mid),
            self.cfg,
        )
        n_inliers = int(lres.n_inliers)
        tracked = lres.tracked.cpu().numpy()
        feat_local = lres.feat_local.cpu().numpy()
        assign = np.where(
            feat_local >= 0, p_ids[np.maximum(feat_local, 0)], assign
        )
        assign = np.where(tracked, assign, -1)

        if n_inliers < 20:
            # tracking lost: fall back to the prediction (the full system
            # attempts relocalization here; VO keeps odometry alive by
            # reseeding landmarks below)
            self.state = "WEAK"
            self.Tcw = Tcw_pred
            assign = np.full(frame.capacity, -1, np.int32)
        else:
            self.state = "OK"
            self.Tcw = lres.Tcw.cpu().numpy()

        self.velocity = (
            self.Tcw @ np.linalg.inv(self.trajectory[-1])
        ).astype(np.float32)

        self.frames_since_kf += 1
        depth = frame.depth.cpu().numpy()
        th_depth = self.cfg.camera.depth_threshold
        tracked_close = int(((depth > 0) & (depth < th_depth) & (assign >= 0)).sum())
        non_tracked_close = int(((depth > 0) & (depth < th_depth) & (assign < 0)).sum())
        need_close = tracked_close < 100 and non_tracked_close > 70
        need_kf = (
            n_inliers > 15
            and (need_close or self.frames_since_kf >= self.cfg.tracking.max_frames)
        ) or self.state == "WEAK"
        if need_kf:
            assign = self._create_landmarks(
                frame, self.Tcw, limit=100, existing=assign
            )
            group = assign[assign >= 0]
            self.kf_groups.append(np.unique(group))
            self.frames_since_kf = 0

        self.last_frame = frame
        self.last_assign = assign
        self.stats.append(
            dict(frame=self.frame_id, matches=n_matches, inliers=n_inliers,
                 tracked_close=tracked_close, new_kf=need_kf,
                 local_points=len(local_ids))
        )

    def _create_landmarks(
        self,
        frame: StereoFrame,
        Tcw: np.ndarray,
        limit: Optional[int],
        existing: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Create landmarks from stereo depths in depth order
        (create_new_key_frame semantics: unassigned features become new
        points until depth > ThDepth and > ``limit`` points exist)."""
        depth = frame.depth.cpu().numpy()
        valid = frame.valid.cpu().numpy()
        octave = frame.octave.cpu().numpy()
        desc = frame.desc.cpu().numpy()
        assign = (
            existing.copy() if existing is not None
            else np.full(frame.capacity, -1, np.int32)
        )

        Twc = np.linalg.inv(Tcw)
        pts_w = unproject(frame, self.cfg,
                          self._dev(Twc.astype(np.float32))).cpu().numpy()
        Ow = Twc[:3, 3]

        cand = np.nonzero((depth > 0) & valid & (assign < 0))[0]
        cand = cand[np.argsort(depth[cand])]
        if limit is not None:
            th_depth = self.cfg.camera.depth_threshold
            total_pts = int((assign >= 0).sum())
            take = []
            for i in cand:
                take.append(i)
                total_pts += 1
                if depth[i] > th_depth and total_pts > limit:
                    break
            cand = np.array(take, dtype=np.int64)
        if len(cand) == 0:
            return assign

        po = pts_w[cand] - Ow
        dist = np.linalg.norm(po, axis=1)
        normal = po / np.maximum(dist[:, None], 1e-6)
        ids = self.landmarks.add(
            pts_w[cand], desc[cand], normal, dist, octave[cand],
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels, ref_kf=-1,
        )
        assign[cand] = ids
        return assign
