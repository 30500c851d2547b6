"""System facade: the full SLAM pipeline (tracking + local mapping).

Port of the synchronous schedule of ``pyorbslam_tpu/slam/system.py``.
API parity with the reference System (System.py:20-168):
``track_stereo``, ``save_trajectory_kitti``, ``reset``, ``shutdown``,
``activate/deactivate_localization_mode``.  The reference's three threads
become a synchronous interleaved schedule: each keyframe insertion
immediately runs the local-mapping step (covisibility update, point
culling, triangulation and fuse, local Schur BA, keyframe culling) before
the next frame is tracked: same semantics, deterministic order, no locks.

``System(cfg, device)`` runs every device step on ``device``; nothing
picks a device for the caller.

Not carried yet, each raising ``NotImplementedError`` with its
``ROADMAP.md`` queue-1 item: the pipelined and windowed schedules
(``track_stereo_async``, ``flush_async``, ``track_stereo_window``,
``window_feed``, ``window_flush``: items 17b and 20), the weak-tracking
fallbacks ``_track_reference_keyframe`` and ``_relocalize`` (item 18) and
loop closing (``enable_loop_closing=True``, item 19).  A fallback that is
not there raises; it never reports "no candidate", which would be a
result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch

from pyorbslam_tpu_torch.config import SlamConfig
from pyorbslam_tpu_torch.place import vocabulary as vocab_mod
from pyorbslam_tpu_torch.place.keyframe_db import KeyFrameDatabase
from pyorbslam_tpu_torch.place.vocabulary import Vocabulary
from pyorbslam_tpu_torch.slam.frame import (
    StereoFrame,
    build_stereo_frame,
    pack_frame,
    unpack_frame_np,
)
from pyorbslam_tpu_torch.slam.kf_ring import DeviceKFRing
from pyorbslam_tpu_torch.slam.local_mapping import LocalMapper
from pyorbslam_tpu_torch.slam.slam_map import SlamMap
from pyorbslam_tpu_torch.slam.tracking import (
    fused_track_step,
    kf_snapshot,
    local_track_step,
    motion_track_step,
)
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls


def _cap_bucket(n: int, max_cap: int) -> int:
    """Pick a padded capacity bucket so device programs stay few-shaped
    while small local maps don't pay full-capacity compute."""
    for b in (2048, 4096, 8192):
        if n <= b and b <= max_cap:
            return b
    return max_cap


_MIRROR_FIELDS = ("pos", "desc", "normal", "dmin", "dmax", "alive")


def _mirror_scatter(mirror, ids: torch.Tensor, rows) -> None:
    """Write changed landmark rows into the device-resident mirror in
    place: a delta update costing |changed| rows instead of the full
    mirror (which grows with the map).  ``ids`` may repeat (padding); the
    repeated rows carry equal values, so the result is defined."""
    for m, r in zip(mirror, rows):
        m.index_copy_(0, ids, r)


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item {item})")


def need_new_keyframe(
    n_inliers: int, n_ref_matches: int, n_kfs: int,
    frame_id: int, last_kf_frame: int, last_reloc_frame: int,
    tracked_close: int, non_tracked_close: int,
    min_frames: int, max_frames: int,
    mapper_idle: bool = True, queue_len: int = 0,
) -> bool:
    """Tracking.need_new_key_frame (Tracking.py:470-520), as a pure
    host predicate.

    Clauses (reference names):
      * reloc guard: no keyframes right after relocalization while the
        map is already mature;
      * bNeedToInsertClose: close points are undertracked;
      * c1a: max_frames elapsed since the last keyframe;
      * c1b: min_frames elapsed and the mapper can accept (always true
        in the synchronous schedule);
      * c1c: inliers collapsed below 0.25x the reference KF's tracked
        points, or close points needed;
      * c2: inliers below thRefRatio x reference (0.75 stereo; 0.4 while
        the map has <2 KFs), or close needed, and at least 15 inliers.
    """
    if frame_id < last_reloc_frame + max_frames and n_kfs > max_frames:
        return False
    need_close = tracked_close < 100 and non_tracked_close > 70
    th_ref_ratio = 0.75 if n_kfs >= 2 else 0.4
    c1a = frame_id >= last_kf_frame + max_frames
    c1b = frame_id >= last_kf_frame + min_frames and mapper_idle
    c1c = n_inliers < n_ref_matches * 0.25 or need_close
    c2 = (n_inliers < n_ref_matches * th_ref_ratio or need_close) \
        and n_inliers > 15
    if not ((c1a or c1b or c1c) and c2):
        return False
    # mapper-busy arbitration (Tracking.py:512-519): in the synchronous
    # schedule the mapper is idle by construction; kept for parity with
    # an async host schedule
    return mapper_idle or queue_len < 3


@dataclasses.dataclass
class System:
    cfg: SlamConfig
    device: torch.device
    landmark_capacity: int = 1 << 18
    keyframe_capacity: int = 4096
    # local BA cadence: every 2nd keyframe.  The reference's LocalMapping
    # aborts an in-flight BA whenever the keyframe queue is non-empty
    # (mbAbortBA, LocalMapping.py:86-106), so its effective cadence under
    # KF-every-3-frames load is below one run per keyframe
    ba_every_n_kf: int = 2
    localization_only: bool = False
    # ablation switch of the JAX package: odometry + mapping without
    # place recognition / loop correction.  True raises until loop
    # closing is ported.
    enable_loop_closing: bool = True
    vocabulary: Optional[Vocabulary] = None  # the shipped asset if absent

    def __post_init__(self):
        if self.enable_loop_closing:
            raise _not_ported(
                "Loop closing (System(enable_loop_closing=True))", "19")
        use_f32_matmuls()
        self.device = torch.device(self.device)
        self.reset()

    # ---------------- public API (reference parity) ----------------

    def reset(self):
        self.map = SlamMap(
            self.cfg, self.device, self.landmark_capacity,
            self.keyframe_capacity)
        self.kfdb = (
            KeyFrameDatabase(self.vocabulary) if self.vocabulary else None
        )
        self.local_mapper = None
        self.kf_ring = DeviceKFRing()
        self.last_reloc_frame = -10**9
        self.state = "NOT_INITIALIZED"
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_frame: Optional[StereoFrame] = None
        self.last_assign: Optional[np.ndarray] = None
        self.lm_created_kf = np.full(self.landmark_capacity, -1, np.int32)
        self.recent_lms: list = []
        self.last_kf_frame = -10**9   # frame id of the last keyframe
        self.frame_id = -1
        self.trajectory: list = []   # raw per-frame Tcw at track time
        self.frame_refs: list = []   # (ref_kf, Tcr): relative log for export
        self.stats: list = []
        self._mirror = None          # device-resident landmark blocks
        self._mirror_stale = True
        self._mirror_shadow = None   # host copy of the uploaded rows
        self._mirror_cap = 0
        self._mirror_pending = np.empty(0, np.int32)  # sub-tolerance dirt
        self._frame_cache = None     # (frame, host snapshot) of the last pull
        self._vocab_cache = None     # (frame, (word, weight, node)) prefetch
        self._snap_prefetch = None   # (frame, device kf_snapshot buffer)
        # schedule diagnostics; bounded, so long runs do not grow host
        # memory per event
        self.events = deque(maxlen=4096)
        self.times = defaultdict(float)   # per-stage wall clock
        self.time_counts = defaultdict(int)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    @contextlib.contextmanager
    def _t(self, label: str):
        """Wall-clock a pipeline stage into ``self.times``.  On a CUDA
        device the stage's queued work is waited for first, so the time
        belongs to the stage that launched it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.times[label] += time.perf_counter() - t0
            self.time_counts[label] += 1

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float) -> np.ndarray:
        self.frame_id += 1
        # upload in the caller's dtype (uint8 preferred: 4x cheaper
        # transfer); build_stereo_frame casts to float32 on the device
        left = self._dev(left)
        right = self._dev(right)
        if self.state == "NOT_INITIALIZED":
            frame = build_stereo_frame(left, right, self.cfg)
            self._stereo_initialization(frame, timestamp)
        else:
            self._track_fused(left, right, timestamp)
        self.trajectory.append(self.Tcw.copy())
        # relative-pose log: frame pose expressed in its reference KF so
        # later BA corrections propagate to the whole trajectory
        # (System.save_trajectory_kitti chaining, System.py:124-145)
        ref = self.map.keyframes.n - 1
        if ref >= 0:
            Tcr = self.Tcw @ np.linalg.inv(self.map.keyframes.Tcw[ref])
            self.frame_refs.append((ref, Tcr.astype(np.float32)))
        else:
            self.frame_refs.append((-1, self.Tcw.copy()))
        return self.Tcw

    def track_stereo_async(self, left, right, timestamp) -> np.ndarray:
        raise _not_ported("System.track_stereo_async (pipelined schedule)",
                          "17b")

    def flush_async(self):
        raise _not_ported("System.flush_async (pipelined schedule)", "17b")

    def track_stereo_window(self, lefts, rights, timestamps) -> np.ndarray:
        raise _not_ported("System.track_stereo_window (windowed schedule)",
                          "20")

    def window_feed(self, lefts, rights, timestamps) -> np.ndarray:
        raise _not_ported("System.window_feed (windowed schedule)", "20")

    def window_flush(self) -> np.ndarray:
        raise _not_ported("System.window_flush (windowed schedule)", "20")

    def _run_maintenance_queue(self, blocking: bool = True):
        raise _not_ported("The deferred keyframe-maintenance queue", "17b")

    def corrected_trajectory(self) -> np.ndarray:
        """Per-frame Tcw with all keyframe corrections applied.  Frames
        whose reference KF was culled chain Tcr through the frozen
        dead-KF relative poses to the nearest live ancestor
        (System.save_trajectory_kitti, System.py:124-145)."""
        out = []
        for (ref, Tcr), raw in zip(self.frame_refs, self.trajectory):
            if ref >= 0:
                ref, Tcr = self.map.resolve_ref(ref, Tcr)
                out.append(Tcr @ self.map.keyframes.Tcw[ref])
            else:
                out.append(raw)
        return np.stack(out) if out else np.zeros((0, 4, 4), np.float32)

    def save_trajectory_kitti(self, path: str):
        """KITTI 3x4 row-major format, one line per frame.  KITTI stores
        camera->world, so each Tcw is inverted before writing: the same
        Rwc = Rcw^T / twc = -Rwc tcw chaining the reference performs
        (System.py:124-147)."""
        with open(path, "w") as f:
            for Tcw in self.corrected_trajectory():
                Tcw = np.asarray(Tcw, dtype=np.float64)
                Rwc = Tcw[:3, :3].T
                twc = -Rwc @ Tcw[:3, 3]
                row = np.hstack([Rwc, twc.reshape(3, 1)]).reshape(-1)
                f.write(" ".join(f"{v:.9e}" for v in row) + "\n")

    def activate_localization_mode(self):
        """Freeze the map (reference System.py:106-112 stops LocalMapping)
        and suppress keyframe creation.  In the synchronous schedule
        nothing is in flight, so there is nothing to drain.  Odometry
        survives unmapped excursions through the hybrid VO queries of the
        fused step (the reference's temporal VO points,
        Tracking.py:612-659)."""
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def shutdown(self):
        """Drain all in-flight work so every fed frame lands in the
        trajectory (System.py:149-167 joins its threads).  The
        synchronous schedule has none; on a CUDA device the queued
        kernels are waited for.  Idempotent."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---------------- initialization ----------------

    def _stereo_initialization(self, frame: StereoFrame, timestamp: float):
        # the reference requires > 500 features at its 2000-feature
        # operating point (Tracking.py:284); scale the gate with the
        # configured budget so small configs can still bootstrap
        n_valid = int(frame.valid.sum())
        if n_valid <= min(500, self.cfg.orb.n_features // 4):
            return
        if self.vocabulary is None:
            # prefer the shipped offline-trained vocabulary (corpus idf);
            # fall back to training a small scene vocabulary from the
            # initial frame (DBoW2 k-majority)
            self.vocabulary = vocab_mod.load_default()
        if self.vocabulary is None:
            d = frame.desc[frame.valid].cpu().numpy()
            self.vocabulary = vocab_mod.train(d, k=10, L=3, seed=0)
        if self.kfdb is None:
            self.kfdb = KeyFrameDatabase(self.vocabulary)
        self.Tcw = np.eye(4, dtype=np.float32)
        self._prefetch_snapshot(frame)
        assign = self._create_landmarks(frame, self.Tcw, limit=None)
        self._insert_keyframe(frame, assign, timestamp, run_ba=False)
        self.last_frame = frame
        self.last_assign = assign
        self.state = "OK"

    # ---------------- per-frame tracking ----------------

    def _landmark_mirror(self, force: bool = False):
        """Device-resident landmark blocks (positions, descriptors,
        normals, distance bands, alive mask), refreshed only after map
        mutations: per-frame tracking gathers from these by index so the
        blocks never cross the host boundary.

        Refreshes are DELTA updates: a host-side shadow copy finds the
        rows any map mutation touched (including native-core kills the
        Python layer never sees) and only those rows are uploaded and
        written into the mirror tensors in place."""
        lm = self.map.landmarks
        if force:
            self._mirror_stale = True
        if self._mirror is not None and not self._mirror_stale:
            return self._mirror
        cap = 1 << 14
        while cap < lm.n:
            cap <<= 1
        cap = min(cap, lm.capacity)

        def full_upload():
            host = tuple(getattr(lm, f)[:cap] for f in _MIRROR_FIELDS)
            # torch.tensor copies: the mirror must not alias the store
            self._mirror = tuple(
                torch.tensor(h, device=self.device) for h in host)
            self._mirror_shadow = tuple(h.copy() for h in host)
            self._mirror_cap = cap
            # shadow now equals host: all dirt is accounted for
            lm.drain_dirty()
            self.map.core.drain_dirty()
            self._mirror_pending = np.empty(0, np.int32)

        if self._mirror is None or self._mirror_cap != cap:
            full_upload()
        else:
            # INCREMENTAL refresh: every mirrored-field writer marks the
            # ids it touched (LandmarkStore.mark_dirty; native kills are
            # drained from mapcore), so the candidate set is O(rows
            # written) instead of an O(capacity) field scan per refresh.
            #
            # Float fields then use a tolerance: local BA jitters
            # thousands of positions by fractions of a millimeter every
            # solve.  The shadow holds the last UPLOADED values;
            # sub-tolerance ids stay in the pending set so drift
            # accumulates against the shadow and still uploads once it
            # matters.  Tolerances are far below the matcher's search
            # radius at any depth.
            cand = np.unique(np.concatenate([
                self._mirror_pending, lm.drain_dirty(),
                self.map.core.drain_dirty()]))
            cand = cand[cand < cap].astype(np.int32)
            tol = dict(pos=2e-3, normal=1e-2, dmin=1e-2, dmax=1e-2)
            changed = np.zeros(len(cand), bool)
            for f, s in zip(_MIRROR_FIELDS, self._mirror_shadow):
                h = getattr(lm, f)[cand]
                if f in tol:
                    d = np.abs(h - s[cand]) > tol[f]
                else:
                    d = h != s[cand]
                changed |= d.any(axis=1) if d.ndim == 2 else d
            ids = cand[changed]
            self._mirror_pending = cand[~changed]
            if len(ids) > cap // 4:
                full_upload()
            elif len(ids):
                pad = 256
                while pad < len(ids):
                    pad <<= 1
                ids_p = np.full(pad, ids[0], np.int32)
                ids_p[: len(ids)] = ids
                rows = tuple(
                    self._dev(getattr(lm, f)[ids_p]) for f in _MIRROR_FIELDS)
                _mirror_scatter(self._mirror, self._dev(ids_p).long(), rows)
                for f, s in zip(_MIRROR_FIELDS, self._mirror_shadow):
                    s[ids] = getattr(lm, f)[ids]
        self._mirror_stale = False
        return self._mirror

    def _track_fused(self, left, right, timestamp: float):
        """Fast path: the whole per-frame hot path as one device program
        (tracking.fused_track_step) + one packed read-back.  Weak
        tracking goes to the step-by-step host path."""
        with self._t("perframe.track"):
            return self._track_fused_inner(left, right, timestamp)

    def _track_fused_inner(self, left, right, timestamp: float):
        lm = self.map.landmarks
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        q_lm = lm.resolve(self.last_assign)
        local_ids = self._local_point_ids(self.last_assign)
        cap = _cap_bucket(len(local_ids), self.cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids

        fres = fused_track_step(
            left, right, *self._landmark_mirror(),
            self._dev(q_lm), self.last_frame,
            self._dev(p_ids), self._dev(Tcw_pred), self._dev(self.Tcw),
            self.cfg,
        )
        packed = fres.packed.cpu().numpy()   # ONE device->host transfer
        n_feat = q_lm.shape[0]
        stats = packed[:5]
        Tcw = packed[5:21].view(np.float32).reshape(4, 4)
        assign = packed[21: 21 + n_feat]
        p_visible = packed[21 + n_feat:].astype(bool)
        n_matches, n_in_motion, n_inliers, tracked_close, non_tracked_close = (
            int(x) for x in stats
        )
        if n_matches < 20 or n_in_motion < 20 or n_inliers < 10:
            # weak tracking: rerun through the host state machine
            self.events.append("sync:weak")
            return self._track(fres.frame, timestamp)

        vis_ids = p_ids[p_visible]
        vis_ids = vis_ids[vis_ids >= 0]
        lm.visible[vis_ids] += 1
        found_ids = np.unique(assign[assign >= 0])
        lm.found[found_ids] += 1
        lm.visible[found_ids] += 1

        self.state = "OK" if n_inliers >= 20 else "MARGINAL"
        self.Tcw = np.array(Tcw, np.float32)
        self._finish_track(
            fres.frame, assign, n_matches, n_inliers,
            tracked_close, non_tracked_close, len(local_ids), timestamp,
        )

    def _track(self, frame: StereoFrame, timestamp: float):
        lm = self.map.landmarks
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        lm_ids = lm.resolve(self.last_assign)
        q_active = lm_ids >= 0
        safe = np.maximum(lm_ids, 0)

        def motion_attempt(th_base):
            return motion_track_step(
                frame,
                self._dev(lm.pos[safe]),
                self._dev(lm.desc[safe]),
                self.last_frame.angle,
                self.last_frame.octave,
                self._dev(q_active & lm.alive[safe]),
                self._dev(Tcw_pred),
                self._dev(self.Tcw),
                self.cfg,
                th_base=th_base,
            )

        res = motion_attempt(7.0)
        assign = None
        if int(res.n_matches) < 20 or int(res.n_inliers) < 20:
            # fallbacks, in the reference's order: BoW matching against
            # the reference keyframe (track_reference_key_frame,
            # Tracking.py:329-356), then a wide-radius projection rescue
            # for large prediction errors BoW can't fix (e.g. sharp turns)
            ref = self._track_reference_keyframe(frame)
            if ref is not None:
                Tcw_mid, assign = ref
                n_matches = int((assign >= 0).sum())
            else:
                res = motion_attempt(28.0)
        if assign is None:
            n_matches = int(res.n_matches)
            feat_query = res.feat_query.cpu().numpy()
            assign = np.where(feat_query >= 0, lm_ids[np.maximum(feat_query, 0)], -1)
            Tcw_mid = res.Tcw.cpu().numpy() if n_matches >= 20 else Tcw_pred

        # local map from covisibility (update_local_keyframes/points)
        local_ids = self._local_point_ids(assign)
        cap = _cap_bucket(len(local_ids), self.cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids
        p_safe = np.maximum(p_ids, 0)
        feat_has = assign >= 0
        feat_xw = lm.pos[np.maximum(assign, 0)]

        lres = local_track_step(
            frame,
            self._dev(feat_xw),
            self._dev(feat_has),
            self._dev(lm.pos[p_safe]),
            self._dev(lm.desc[p_safe]),
            self._dev(lm.normal[p_safe]),
            self._dev(lm.dmin[p_safe]),
            self._dev(lm.dmax[p_safe]),
            self._dev(p_ids >= 0),
            self._dev(Tcw_mid),
            self.cfg,
        )
        n_inliers = int(lres.n_inliers)
        tracked = lres.tracked.cpu().numpy()
        feat_local = lres.feat_local.cpu().numpy()
        assign = np.where(feat_local >= 0, p_ids[np.maximum(feat_local, 0)], assign)
        assign = np.where(tracked, assign, -1).astype(np.int32)

        # found / visible counters (track_local_map bookkeeping)
        vis_ids = p_ids[lres.p_visible.cpu().numpy()]
        vis_ids = vis_ids[vis_ids >= 0]
        lm.visible[vis_ids] += 1
        found_ids = np.unique(assign[assign >= 0])
        lm.found[found_ids] += 1
        lm.visible[found_ids] += 1

        if n_inliers >= 10:
            # accept: the reference keeps the optimized pose even when
            # flagging weak tracking; discarding a 10+-inlier solution
            # cascades into permanent loss
            self.state = "OK" if n_inliers >= 20 else "MARGINAL"
            self.Tcw = lres.Tcw.cpu().numpy()
        else:
            reloc = self._relocalize(frame)
            if reloc is not None:
                self.state = "OK"
                self.Tcw, assign = reloc
                self.last_reloc_frame = self.frame_id
            else:
                self.state = "WEAK"
                self.Tcw = Tcw_pred
                assign = np.full(frame.capacity, -1, np.int32)

        depth = frame.depth.cpu().numpy()
        valid = frame.valid.cpu().numpy()
        th_depth = self.cfg.camera.depth_threshold
        close = (depth > 0) & (depth < th_depth) & valid
        tracked_close = int((close & (assign >= 0)).sum())
        non_tracked_close = int((close & (assign < 0)).sum())
        self._finish_track(
            frame, assign, n_matches, n_inliers,
            tracked_close, non_tracked_close, len(local_ids), timestamp,
        )

    def _finish_track(self, frame, assign, n_matches, n_inliers,
                      tracked_close, non_tracked_close, n_local,
                      timestamp):
        self.velocity = (
            self.Tcw @ np.linalg.inv(self.trajectory[-1])
        ).astype(np.float32)

        # keyframe decision (Tracking.need_new_key_frame parity), plus:
        # MARGINAL frames force a keyframe (refresh the local map before
        # tracking dies); WEAK frames with failed relocalization reseed via
        # a keyframe as the last resort so odometry survives unmapped
        # excursions (the reference's auto-reset analog, Tracking.py:258-262)
        trk = self.cfg.tracking
        ks = self.map.keyframes
        # mnMatchesInliers counts ALL tracked map points in the frame
        # (Tracking.py:375-382), not just stereo-edge pose-opt inliers:
        # the ratio clauses are calibrated against that count
        n_tracked_points = int((assign >= 0).sum())
        need_kf = not self.localization_only and (
            (self.state == "OK" and need_new_keyframe(
                n_inliers=n_tracked_points,
                n_ref_matches=self._ref_kf_tracked_points(),
                n_kfs=int(ks.alive[: ks.n].sum()),
                frame_id=self.frame_id,
                last_kf_frame=self.last_kf_frame,
                last_reloc_frame=self.last_reloc_frame,
                tracked_close=tracked_close,
                non_tracked_close=non_tracked_close,
                min_frames=trk.min_frames, max_frames=trk.max_frames,
                mapper_idle=(
                    self.frame_id
                    >= self.last_kf_frame + trk.mapper_latency_frames
                ),
                queue_len=0,
            ))
            or self.state == "MARGINAL"
            or self.state == "WEAK"
        )
        if need_kf:
            # one combined snapshot+BoW read instead of two round trips
            if self._frame_cache is None or self._frame_cache[0] is not frame:
                self._prefetch_snapshot(frame)
            assign = self._create_landmarks(frame, self.Tcw, limit=100,
                                            existing=assign)
            kf_id = self._insert_keyframe(frame, assign, timestamp, run_ba=True)
            # local mapping may have added triangulated/fused bindings to
            # this keyframe; carry them into the tracker state
            assign = self.map.keyframes.obs_lm[kf_id].copy()

        self.last_frame = frame
        self.last_assign = assign
        self.stats.append(
            dict(frame=self.frame_id, matches=n_matches, inliers=n_inliers,
                 tracked_points=n_tracked_points,
                 tracked_close=tracked_close, new_kf=need_kf,
                 state=self.state,
                 local_points=n_local, n_kfs=self.map.keyframes.n,
                 n_landmarks=int(self.map.landmarks.alive.sum())),
        )

    # ---------------- local mapping (synchronous) ----------------

    def _prefetch_snapshot(self, frame: StereoFrame):
        """Launch the keyframe snapshot+BoW program for a device-resident
        frame.  Costs no host read if never consumed (the buffer is
        dropped); consumed lazily by :meth:`_frame_host`."""
        if self.vocabulary is None:
            return
        if self._snap_prefetch is not None and \
                self._snap_prefetch[0] is frame:
            return
        voc = self.vocabulary
        buf = kf_snapshot(
            frame, voc._device_arrays(self.device), voc.k, voc.L,
            voc.feature_levels_up)
        self._snap_prefetch = (frame, buf)

    def _frame_host(self, frame: StereoFrame) -> dict:
        """Host snapshot of a frame's per-feature arrays, pulled in ONE
        device->host transfer and cached per frame object."""
        if self._frame_cache is not None and self._frame_cache[0] is frame:
            return self._frame_cache[1]
        if self._snap_prefetch is not None and self._snap_prefetch[0] is frame:
            with self._t("kf.snapshot_read"):
                buf = self._snap_prefetch[1].cpu().numpy()
            self._snap_prefetch = None
            n = frame.capacity
            snap = unpack_frame_np(buf[: 16 * n], n)
            self._frame_cache = (frame, snap)
            self._vocab_cache = (frame, (
                buf[16 * n: 17 * n],
                buf[17 * n: 18 * n].view(np.float32),
                buf[18 * n: 19 * n],
            ))
            return snap
        snap = unpack_frame_np(pack_frame(frame).cpu().numpy(), frame.capacity)
        self._frame_cache = (frame, snap)
        return snap

    def _insert_keyframe(self, frame: StereoFrame, assign: np.ndarray,
                         timestamp: float, run_ba: bool):
        with self._t("kf.insert_total"):
            return self._insert_keyframe_inner(
                frame, assign, timestamp, run_ba)

    def _insert_keyframe_inner(self, frame: StereoFrame, assign: np.ndarray,
                               timestamp: float, run_ba: bool):
        frame_np = self._frame_host(frame)
        if self._vocab_cache is not None and self._vocab_cache[0] is frame:
            word, wweight, node = self._vocab_cache[1]   # snapshot prefetch
        else:
            word, wweight, node = self.vocabulary.transform(
                frame.desc, levels_up=self.vocabulary.feature_levels_up)
        kf = self.map.add_keyframe(
            frame_np, self.Tcw, assign, self.frame_id, timestamp,
            kp_node=node,
        )
        self.kf_ring.insert(kf, frame)
        bow = self.vocabulary.bow_vector(word, wweight, frame_np["valid"])
        self.kfdb.add(kf, bow)
        if self.local_mapper is None:
            self.local_mapper = LocalMapper(
                self.cfg, self.map,
                ring=self.kf_ring, mirror_fn=self._landmark_mirror)
        new_ids = assign[(assign >= 0) & (self.lm_created_kf[np.maximum(assign, 0)] < 0)]
        self.lm_created_kf[new_ids] = kf
        self.recent_lms.append(np.unique(assign[assign >= 0]))
        self.last_kf_frame = self.frame_id

        # map-point culling over landmarks created in the last 3 KFs
        if len(self.recent_lms) > 3:
            self.map.cull_map_points(
                self.recent_lms[-3], kf, self.lm_created_kf
            )

        self._mirror_stale = True   # the store changed; re-upload lazily
        if run_ba:
            self._kf_maintenance(kf, bow, deferred=False)
        return kf

    def _kf_maintenance(self, kf: int, bow, deferred: bool):
        """LocalMapping work for one keyframe (LocalMapping.run order:
        triangulate new points over covisible neighbors, fuse duplicates,
        local BA, keyframe culling).  The loop-closing stage that follows
        in the JAX package is not carried yet (``enable_loop_closing``
        is refused at construction).  ``deferred`` = running after later
        frames were already tracked: pose refinements fold into the live
        pose as a rigid delta instead of being adopted directly."""
        if self.local_mapper is not None:
            # triangulation + both fuse directions as ONE device program
            # + ONE packed read (LocalMapper.maintain)
            with self._t("kf.maintain"):
                info = self.local_mapper.maintain(kf)
            self.events.append(("maintain", kf, info))

        if kf % self.ba_every_n_kf == 0:
            pre = self.map.keyframes.Tcw[kf].copy()
            with self._t("kf.local_ba"):
                info = self.map.local_ba(kf)
            self.events.append(("local_ba", kf, info))
            if info.get("ran"):
                if deferred:
                    delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(pre)
                    self.Tcw = (delta @ self.Tcw).astype(np.float32)
                else:
                    # adopt the BA-refined pose for the current camera
                    self.Tcw = self.map.keyframes.Tcw[kf].copy()

        if self.local_mapper is not None and kf % 4 == 0:
            self.local_mapper.cull_keyframes(
                kf, on_removed=lambda k: self.kfdb.erase(k))
        self._mirror_stale = True

    # ---------------- weak-tracking fallbacks (not carried yet) ----------

    def _track_reference_keyframe(self, frame: StereoFrame):
        raise _not_ported(
            "System._track_reference_keyframe (BoW fallback on weak "
            "motion tracking)", "18")

    def _relocalize(self, frame: StereoFrame):
        raise _not_ported(
            "System._relocalize (relocalization after tracking loss)", "18")

    # ---------------- helpers ----------------

    def _ref_kf_tracked_points(self) -> int:
        """KeyFrame.tracked_map_points(minObs) for the reference (latest)
        keyframe: its observed landmarks with enough total observations
        (Tracking.py:483-487; stereo observations count 2)."""
        ks = self.map.keyframes
        ref = ks.n - 1
        if ref < 0:
            return 0
        min_obs = 3 if ks.alive[: ks.n].sum() > 2 else 2
        ids = self.map.landmarks.resolve(ks.obs_lm[ref])
        ids = ids[ids >= 0]
        lm = self.map.landmarks
        ids = ids[lm.alive[ids]]
        return int((lm.n_obs[ids] >= min_obs).sum())

    def _spatial_point_ids(self, Tcw: np.ndarray,
                           radius: float = 80.0) -> np.ndarray:
        """Local map for a windowed schedule: every live landmark within
        ``radius`` of the camera, nearest-first when over capacity."""
        lm = self.map.landmarks
        n = lm.n
        if n == 0:
            return np.empty(0, np.int32)
        Ow = -Tcw[:3, :3].T @ Tcw[:3, 3]
        d2 = ((lm.pos[:n] - Ow) ** 2).sum(1)
        sel = lm.alive[:n] & (d2 < radius * radius)
        ids = np.nonzero(sel)[0]
        cap = self.cfg.tracking.max_local_points
        if len(ids) > cap:
            ids = ids[np.argpartition(d2[ids], cap)[:cap]]
        return ids.astype(np.int32)

    def _local_point_ids(self, assign: np.ndarray) -> np.ndarray:
        """update_local_keyframes + update_local_points (Tracking.py:392-436):
        KFs observing currently-assigned landmarks, plus their best
        covisible neighbors; local points = union of their observations.
        One native call (mapcore_local_points)."""
        tracked = np.unique(assign[assign >= 0])
        if len(tracked) == 0:
            return np.empty(0, np.int32)
        return self.map.core.local_points(
            tracked, self.cfg.tracking.max_local_points)

    def _create_landmarks(self, frame: StereoFrame, Tcw: np.ndarray,
                          limit: Optional[int],
                          existing: Optional[np.ndarray] = None) -> np.ndarray:
        """Depth-ordered stereo landmark creation (create_new_key_frame,
        Tracking.py:523-576)."""
        lm = self.map.landmarks
        snap = self._frame_host(frame)
        depth = snap["depth"]
        valid = snap["valid"]
        octave = snap["octave"]
        desc = snap["desc"]
        assign = (existing.copy() if existing is not None
                  else np.full(frame.capacity, -1, np.int32))

        Twc = np.linalg.inv(Tcw)
        # host-side unproject (Frame.unproject_stereo semantics): the
        # snapshot already holds everything; no extra device round trip
        cam = self.cfg.camera
        z = depth
        pc = np.stack([
            (snap["xy"][:, 0] - cam.cx) * z / cam.fx,
            (snap["xy"][:, 1] - cam.cy) * z / cam.fy,
            z,
        ], axis=-1)
        pts_w = (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)
        Ow = Twc[:3, 3]

        cand = np.nonzero((depth > 0) & valid & (assign < 0))[0]
        cand = cand[np.argsort(depth[cand])]
        if limit is not None:
            th_depth = self.cfg.camera.depth_threshold
            total = int((assign >= 0).sum())
            take = []
            for i in cand:
                take.append(i)
                total += 1
                if depth[i] > th_depth and total > limit:
                    break
            cand = np.array(take, dtype=np.int64)
        if len(cand) == 0:
            return assign

        po = pts_w[cand] - Ow
        dist = np.linalg.norm(po, axis=1)
        normal = po / np.maximum(dist[:, None], 1e-6)
        ids = lm.add(
            pts_w[cand], desc[cand], normal, dist, octave[cand],
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels,
            ref_kf=self.map.keyframes.n,
        )
        assign[cand] = ids
        return assign
