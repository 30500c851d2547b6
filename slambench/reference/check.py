"""The comparison that decides ``correct``.

What the timed path produced (the poses it gave back, its keyframes after
local BA with their features, its live landmarks) is held against the
generator's truth and against the plain ORB of ``orb.py`` worked out again
from the same images:

``frontend_bad_pct``  share of the keyframes' keypoints that fail one of:
    a FAST-9 corner at the settings' lower threshold on the reference
    pyramid (K1); a descriptor within ``DESC_BITS`` bits of the reference
    rBRIEF at the reference orientation (K2); for a stereo keypoint, a
    disparity bf / depth within ``DISPARITY_PX`` of the true one (stereo
    matching and depth).
``pose_ate_pct``      the worst session's ATE of the poses given back,
    one a frame, against the route, in % of the route's length.
``kf_ate_pct``        the worst session's ATE of its live keyframes'
    poses after local BA, in % of the route's length.
``lm_gap_m``          the worst session's median distance of its live
    landmarks, carried by the keyframes' alignment onto the truth, to the
    nearest surface of the scene.
``open_loop_sessions`` the number of sessions whose loop closer closed no
    loop: compared (limit 0) in a cell whose every session drives back
    past its start.
``false_loops``       the worst session's count of the loop closer's
    corrections (``loop_pairs``: the keyframe and candidate frames that
    reached the correction) whose true camera centres lie more than
    ``FALSE_LOOP_M`` apart: no revisit of one place, whether the program
    then kept the correction or rolled it back.  Compared (limit 0) where
    a limits file names it.

A number that is not finite anywhere in what a session gave back (a
pose, a keyframe's keypoint or pose, a landmark) makes the number it
feeds inf, and ``correct`` false.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ate, geometry, orb

DESC_BITS = 32          # of 256: a descriptor further off is another one
DISPARITY_PX = 1.0
MAX_KEYFRAMES = 64      # keyframes checked a run, drawn from the seed
# a revisit's keyframes lie within a few metres of each other; pillar
# faces that shared one patch of the texture, and that the loop closer
# joined, lay 36-65 m apart
FALSE_LOOP_M = 10.0


def read_settings(path: str) -> dict:
    """What the check needs of an ORB-SLAM2 settings file (``key: value``
    lines under a ``%YAML:1.0`` header), read on its own."""
    raw = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if ":" in line and not line.startswith("%"):
                key, val = (p.strip() for p in line.split(":", 1))
                if val:
                    raw[key] = float(val)
    return dict(bf=raw["Camera.bf"], scale_factor=raw["ORBextractor.scaleFactor"],
                n_levels=int(raw["ORBextractor.nLevels"]),
                min_th_fast=raw["ORBextractor.minThFAST"])


def path_length(poses_wc: np.ndarray) -> float:
    return float(np.linalg.norm(np.diff(poses_wc[:, :3, 3], axis=0), axis=1).sum())


def finite_features(session: dict) -> bool:
    """Whether every valid keypoint of every keyframe has a finite
    position and depth."""
    valid = session["kf_valid"]
    return bool(np.isfinite(session["kf_xy"][valid]).all()
                and np.isfinite(session["kf_depth"][valid]).all())


def frontend_bad(session: dict, kf: int, route, settings: dict, device) -> tuple:
    """(bad keypoints, keypoints) of keyframe ``kf`` of ``session`` (its
    positions finite).  A keypoint on no level of the pyramid, or too near
    its level's edge for the FAST ring, is bad."""
    valid = session["kf_valid"][kf]
    if not valid.any():
        return 0, 0
    frame = int(session["kf_frame"][kf])
    xy = session["kf_xy"][kf][valid].astype(np.float64)
    octave = session["kf_octave"][kf][valid]
    desc = orb.words_to_bits(session["kf_desc"][kf][valid])
    depth = session["kf_depth"][kf][valid].astype(np.float64)
    scale, n_levels = settings["scale_factor"], settings["n_levels"]
    img = torch.as_tensor(route.left[frame], device=device)
    levels = orb.pyramid(img, scale, n_levels)
    bad = (octave < 0) | (octave >= n_levels)
    for lvl in np.unique(octave[~bad]):
        level = levels[int(lvl)]
        s = float(np.float32(scale ** float(lvl)))
        ix, iy = np.rint(xy[:, 0] / s), np.rint(xy[:, 1] / s)
        inside = (ix >= 3) & (ix < level.shape[1] - 3) & (iy >= 3) & (iy < level.shape[0] - 3)
        bad |= (octave == lvl) & ~inside
        sel = np.nonzero((octave == lvl) & inside)[0]
        if not len(sel):
            continue
        lx = torch.as_tensor(ix[sel].astype(np.int64), device=device)
        ly = torch.as_tensor(iy[sel].astype(np.int64), device=device)
        corner = orb.fast_strength(level, lx, ly) > settings["min_th_fast"]
        padded = orb.reflect101(level, orb.BORDER)
        bits = orb.rbrief(orb.blur_u8(padded), lx, ly, orb.ic_angle(padded, lx, ly))
        far = (bits.cpu().numpy() != desc[sel]).sum(axis=1) > DESC_BITS
        bad[sel] |= ~corner.cpu().numpy() | far
    stereo = depth > 0
    if stereo.any():
        K = route.camera.K
        z = geometry.ray_depth(route.planes, route.poses_wc[frame], K, xy[stereo])
        bf = settings["bf"]
        gap = np.abs(bf / depth[stereo] - bf / z)
        bad[np.nonzero(stereo)[0]] |= ~(gap <= DISPARITY_PX)
    return int(bad.sum()), len(xy)


def false_loops(session: dict, poses_wc: np.ndarray) -> int:
    """The session's corrections between frames whose true camera centres
    lie more than ``FALSE_LOOP_M`` apart."""
    centres = poses_wc[:, :3, 3]
    return sum(float(np.linalg.norm(centres[a] - centres[b])) > FALSE_LOOP_M
               for a, b in session.get("loop_pairs", ()))


def numbers(sessions, route, settings: dict, seed: int, device) -> dict:
    """The compared numbers of one run (see the module docstring)."""
    gt = route.poses_wc
    length = path_length(gt)
    pose_ate, kf_ate, lm_gap = [], [], []
    picks = [(s, k) for s, ses in enumerate(sessions) for k in range(len(ses["kf_frame"]))]
    broken = not all(finite_features(ses) for ses in sessions)
    for ses in sessions:
        poses = ses["poses"]
        if len(poses) < ses["n_handed"] or not np.isfinite(poses).all():
            pose_ate.append(float("inf"))
        else:
            est = np.linalg.inv(poses)
            pose_ate.append(100.0 * ate.ate_rmse(est, gt[: len(est)]) / length)
        frames = ses["kf_frame"]
        if len(frames) < 3 or not np.isfinite(ses["kf_Tcw"]).all():
            kf_ate.append(float("inf"))
            lm_gap.append(float("inf"))
            continue
        kf_wc = np.linalg.inv(ses["kf_Tcw"])
        kf_ate.append(100.0 * ate.ate_rmse(kf_wc, gt[frames]) / length)
        _, R, t = ate.umeyama_alignment(kf_wc[:, :3, 3], gt[frames][:, :3, 3])
        pts = ses["lm_pos"] @ R.T + t
        lm_gap.append(float(np.median(geometry.surface_distance(route.planes, pts)))
                      if len(pts) and np.isfinite(pts).all() else float("inf"))
    rng = np.random.default_rng(seed % (1 << 63))
    if len(picks) > MAX_KEYFRAMES:
        picks = [picks[i] for i in sorted(rng.choice(len(picks), MAX_KEYFRAMES, replace=False))]
    bad = total = 0
    for s, k in [] if broken else picks:
        b, n = frontend_bad(sessions[s], k, route, settings, device)
        bad, total = bad + b, total + n
    return dict(frontend_bad_pct=100.0 * bad / total if total else float("inf"),
                pose_ate_pct=worst(pose_ate), kf_ate_pct=worst(kf_ate), lm_gap_m=worst(lm_gap),
                open_loop_sessions=sum(ses.get("loops_closed", 0) < 1 for ses in sessions),
                false_loops=max(false_loops(ses, gt) for ses in sessions))


def worst(values: list) -> float:
    """The largest, or inf where one is not finite (``max`` drops a NaN
    that is not first)."""
    return max(v if np.isfinite(v) else float("inf") for v in values)


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit, and finite."""
    rows = [(name, float(values[name]), float(limits[name]["limit"])) for name in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok and len(rows) > 0, rows
