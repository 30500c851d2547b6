"""System facade: the full SLAM pipeline (tracking, local mapping, loop
closing).

Port of ``pyorbslam_tpu/slam/system.py``'s per-frame schedules.  API
parity with the reference System (System.py:20-168): ``track_stereo``,
``save_trajectory_kitti``, ``reset``, ``shutdown``,
``activate/deactivate_localization_mode``.  The reference's three threads
become one of three schedules on one host thread:

* ``track_stereo``, synchronous and interleaved: each keyframe insertion
  immediately runs the local-mapping step (covisibility update, point
  culling, triangulation and fuse, local Schur BA, keyframe culling)
  before the next frame is tracked: same semantics, deterministic order,
  no locks;
* ``track_stereo_async`` / ``flush_async``, pipelined: a frame's fused
  tracking program is dispatched and its packed result row starts copying
  to the host at once; the row is read and committed at the NEXT call, and
  a committed keyframe's mapping work advances one device stage per
  tracked frame behind the dispatch (``_run_maintenance_queue``);
* ``track_stereo_window`` and ``window_feed`` / ``window_flush``,
  windowed: W frames are tracked by one device loop
  (``tracking.fused_track_window``) against a local map frozen for the
  window, and one read brings the W rows to the host, which then commits
  them frame by frame; a frame that needs a keyframe, or whose anchoring
  weakened, is first re-tracked on the device against the current map
  from the features the scan built (``_retrack_window_frame``).
  ``window_feed`` dispatches window N + 1, seeded with the host's state
  as window N's commit left it, before it runs window N's mapping work.

A frame that tracks weakly goes through the full per-frame state machine
(``_track``): motion retry, BoW matching against the reference keyframe
(``_track_reference_keyframe``), a wide-radius rescue and relocalization
(``_relocalize``: BoW candidates, EPnP RANSAC, projection rescue).

Loop closing (``slam/loop_closing.py``) is on by default, as in the JAX
package: every keyframe's mapping pass ends with the loop stage
(detection, Sim3, correction with its essential graph) and, after a
closure, one bounded global-BA slice per keyframe.

``System(cfg, device)`` runs every device step on ``device``; nothing
picks a device for the caller.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Optional

import numpy as np
import torch

from pyorbslam_tpu_torch.config import SlamConfig
from pyorbslam_tpu_torch.io.kitti import save_trajectory_kitti
from pyorbslam_tpu_torch.ops import matching as match_ops
from pyorbslam_tpu_torch.ops.hamming import popcount
from pyorbslam_tpu_torch.optim import pose_opt
from pyorbslam_tpu_torch.optim.epnp import epnp_ransac
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
from pyorbslam_tpu_torch.slam.loop_closing import LoopCloser
from pyorbslam_tpu_torch.slam.slam_map import SlamMap
from pyorbslam_tpu_torch.slam.tracking import (
    TrackRow,
    fused_retrack_step,
    fused_track_chain_step,
    fused_track_window,
    graphed_snapshot,
    local_track_step,
    motion_track_step,
    read_row,
    read_snapshot,
)
from pyorbslam_tpu_torch.utils import trace
from pyorbslam_tpu_torch.utils.host_read import HostRead, upload
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls

# ``System.times`` keys that are sums of stage clocks, not stages: the
# keyframe side's host time with each stretch counted once (keyframe
# stages nest: the synchronous mapping runs inside insertion), and the
# part of it that ran inside a window's commit
KEYFRAME_SIDE = "keyframe_side"
WINDOW_COMMIT_KF = "window.commit_kf"


class _KeyframeStage(trace.stage):
    """A keyframe stage's clock (``kf.*``): the outermost one open also
    adds its time to ``times[KEYFRAME_SIDE]``."""

    __slots__ = ("system",)

    def __init__(self, system, label, sync):
        super().__init__(system.times, label, system.time_counts, sync)
        self.system = system

    def __enter__(self):
        self.system._kf_depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        before = self.times[self.label]
        super().__exit__(*exc)
        self.system._kf_depth -= 1
        if not self.system._kf_depth:
            self.times[KEYFRAME_SIDE] += self.times[self.label] - before
        return False


def _rigid(T: np.ndarray) -> np.ndarray:
    """The nearest rigid transform to ``T``: its rotation block projected
    onto SO(3) (SVD in float64), its translation kept."""
    U, _, Vt = np.linalg.svd(np.asarray(T[:3, :3], np.float64))
    out = np.array(T, np.float32)
    out[:3, :3] = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    return out


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
    # windowed schedule: a scanned frame is committed as it is only while
    # its local-map anchoring stays at least this strong; a weaker one is
    # re-tracked against the current map first.  Guards against the
    # map-feedback drift of committing weakly anchored poses
    window_commit_min_inliers: int = 90
    localization_only: bool = False
    # ablation switch for drift-repair evaluation: odometry + mapping
    # without place recognition / loop correction
    enable_loop_closing: bool = True
    vocabulary: Optional[Vocabulary] = None  # the shipped asset if absent

    def __post_init__(self):
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
        self.loop_closer = None
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
        self._snap_prefetch = None   # (frame, kf_snapshot HostRead)
        # ---- windowed schedule state ----
        # while a window commits, the mapper counts as busy (the
        # reference's async LocalMapping while its queue drains,
        # LocalMapping.py:86-106): keyframe insertion then needs c1a / c1c
        # and is capped by the queue arbitration
        self._mapper_queue = None    # None = idle (per-frame schedules)
        self._pending_window = None  # in-flight window of window_feed
        # ---- pipelined per-frame (async) schedule state ----
        self._async_q: list = []     # in-flight dispatch records (<= 1)
        self._defer_maintenance = False  # commit in progress: queue KF work
        self._maint_queue: list = []     # (kf, bow) awaiting mapping work
        self._maint_pipe: list = []      # staged in-flight mapping items
        # schedule diagnostics; bounded, so long runs do not grow host
        # memory per event
        self.events = deque(maxlen=4096)
        self.times = defaultdict(float)   # per-stage wall clock
        self.time_counts = defaultdict(int)
        self._kf_depth = 0                # keyframe stages open

    def _dev(self, a) -> torch.Tensor:
        """A host array on the device; on CUDA through pinned memory and a
        non-blocking copy, so an upload never makes the host wait for the
        work queued before it."""
        return upload(a, self.device)

    def _t(self, label: str, sync: bool = True):
        """Wall-clock a pipeline stage into ``self.times`` (and a span
        while tracing is on, ``utils/trace.py``).  On a CUDA
        device the stage's queued work is waited for first, so the time
        belongs to the stage that launched it; the stages of the
        pipelined schedule (``sync=False``, and everything a pipelined
        commit runs) exist to leave work in flight and are timed on the
        host alone.  A keyframe stage (``kf.*``) also counts, when no other
        is open around it, towards ``times[KEYFRAME_SIDE]``."""
        wait = self._stage_wait if sync else None
        if label.startswith("kf."):
            return _KeyframeStage(self, label, wait)
        return trace.stage(self.times, label, self.time_counts, wait)

    def _stage_wait(self):
        if not self._defer_maintenance and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
        self._append_frame_ref()
        return self.Tcw

    # ---------------- pipelined per-frame (async) schedule ----------------
    #
    # Each call, in order:
    #   1. ENQUEUE the new frame's image upload (pinned, non-blocking: the
    #      transfer streams while everything below runs);
    #   2. COMMIT the frame dispatched last call: its packed row has been
    #      copying to the host since dispatch, so the read does not stall;
    #      the commit updates pose/state, decides and INSERTS a keyframe
    #      (bindings + stereo landmarks + BoW registration), whose feature
    #      snapshot was prefetched speculatively at dispatch;
    #   3. DISPATCH this frame's fused tracking step against the map as
    #      of the commit (same freshness as the synchronous path);
    #   4. advance the committed keyframes' MAPPING work (triangulation,
    #      fuse, local BA) one device stage each, queued behind the
    #      tracking step: the reference's async Tracking / LocalMapping
    #      split (System.py:58-64, LocalMapping.py:43-84); its pose
    #      refinements fold into the in-flight frame at its commit.

    def track_stereo_async(self, left, right, timestamp) -> np.ndarray:
        """Feed one stereo pair into the pipelined schedule; returns the
        pose of the last COMMITTED frame (one frame behind the feed;
        call :meth:`flush_async` to commit the tail).  Falls back to the
        synchronous per-frame machine until initialized or after a
        tracking loss."""
        # the frames in flight commit first: this one's id comes after them
        with trace.span("call.async", self.frame_id + 1 + len(self._async_q)):
            return self._track_stereo_async_inner(left, right, timestamp)

    def _track_stereo_async_inner(self, left, right, timestamp):
        if self.state not in ("OK", "MARGINAL") or self.map.keyframes.n == 0:
            self.flush_async()
            return self.track_stereo(left, right, timestamp)
        left = self._dev(left)       # upload streams under the commit
        right = self._dev(right)
        if self._async_q:
            self._commit_chain(self._async_q.pop(0))
        if self.state in ("OK", "MARGINAL") and self.map.keyframes.n > 0:
            self._dispatch_chain(left, right, timestamp)
            # one device stage per in-flight keyframe: dispatches queue
            # behind the tracking step; reads consume results dispatched
            # a frame ago (already copied)
            self._run_maintenance_queue(blocking=False)
        else:
            # the commit lost tracking: this frame goes through the
            # synchronous rescue machine instead
            self._run_maintenance_queue()
            self.track_stereo(left, right, timestamp)
        return self.Tcw

    def flush_async(self):
        """Commit every in-flight pipelined frame."""
        # the id of the first frame it commits
        with trace.span("call.flush", self.frame_id + 1):
            while self._async_q:
                self._commit_chain(self._async_q.pop(0))
            self._run_maintenance_queue()

    def _dispatch_chain(self, left, right, timestamp):
        # the id this frame is given at its commit
        fid = self.frame_id + 1
        with self._t("async.dispatch", sync=False) as sp:
            if sp is not None:
                sp.frame = fid
            rec = self._dispatch_chain_inner(left, right, timestamp)
            rec["frame_id"] = fid
            if sp is not None:
                sp.args.update(n_feat=rec["n_feat"], n_local=rec["n_local"])

    def _dispatch_chain_inner(self, left, right, timestamp):
        mirror = self._landmark_mirror()
        local_ids = self._local_point_ids(self.last_assign)
        p_ids = self._pad_ids(local_ids)

        q_lm = self._last_lm_ids()
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        # the host arrays go up through pinned memory into the step's inputs
        row, frame = fused_track_chain_step(
            left, right, *mirror, self.last_frame, q_lm, Tcw_pred,
            self.Tcw, p_ids, self.cfg,
        )
        # the read-back overlaps the next commit and dispatch
        row = HostRead(row)
        # speculative keyframe-snapshot prefetch: if this frame becomes a
        # keyframe at commit, its feature snapshot + BoW will already be
        # on the host.  Only the frame IMMEDIATELY after a keyframe skips
        # it (the JAX package's rule, its system.py:342)
        if self.frame_id + 1 - self.last_kf_frame >= 1:
            self._prefetch_snapshot(frame)
        rec = dict(
            row=row, frame=frame, base=self.Tcw.copy(),
            p_ids=p_ids, n_local=len(local_ids),
            n_feat=int(q_lm.shape[0]), timestamp=timestamp,
        )
        self._async_q.append(rec)
        return rec

    def _commit_chain(self, rec):
        n_kfs = self.map.keyframes.n
        with self._t("async.commit", sync=False) as sp:
            if sp is not None:
                sp.frame = rec["frame_id"]
            self._commit_chain_inner(rec)
            if sp is not None:
                n = self.map.keyframes.n
                sp.args["kf"] = n - 1 if n > n_kfs else -1

    def _commit_chain_inner(self, rec):
        self.frame_id += 1
        with self._t("async.read", sync=False):
            out = rec["row"].numpy()
        row = read_row(out, rec["n_feat"], len(rec["p_ids"]))
        sp = trace.current()    # the commit's
        if sp is not None:
            sp.args.update(matches=row.n_matches, inliers_motion=row.n_in_motion,
                           inliers_local=row.n_in_local, rescue=0)

        # deferred maintenance may have refined the pose this frame's
        # prediction chained from (rec["base"]); rebase preserving the
        # tracked relative motion.  base == self.Tcw in the common
        # no-refinement case, making this exactly the row's pose.
        healthy = (row.n_matches >= 20 and row.n_in_motion >= 20
                   and row.n_in_local >= 10 and bool(np.isfinite(row.Tcw).all()))
        if not healthy:
            # weak tracking: the full per-frame state machine (motion
            # retry, BoW reference-KF fallback, wide rescue, reloc)
            # takes this frame
            self.events.append("async:rescue")
            if sp is not None:
                sp.args["rescue"] = 1
            self._track(rec["frame"], rec["timestamp"])
            self.trajectory.append(self.Tcw.copy())
            self._append_frame_ref()
            return
        row = row._replace(
            Tcw=np.ascontiguousarray(
                row.Tcw @ np.linalg.inv(rec["base"]) @ self.Tcw, np.float32),
            assign=self._live_assign(row.assign))
        # keyframe mapping work is deferred past the next dispatch (the
        # device tracks while the host runs it)
        self._defer_maintenance = True
        try:
            self._adopt_row(rec["frame"], row, rec["p_ids"], rec["timestamp"])
        finally:
            self._defer_maintenance = False
        self.trajectory.append(self.Tcw.copy())
        self._append_frame_ref()

    def _append_frame_ref(self):
        """Relative-pose log: the frame's pose expressed in its reference
        KF, so later BA corrections propagate to the whole trajectory
        (System.save_trajectory_kitti chaining, System.py:124-145)."""
        ref = self.map.keyframes.n - 1
        if ref >= 0:
            Tcr = self.Tcw @ np.linalg.inv(self.map.keyframes.Tcw[ref])
            self.frame_refs.append((ref, Tcr.astype(np.float32)))
        else:
            self.frame_refs.append((-1, self.Tcw.copy()))

    # ---------------- windowed schedule ----------------
    #
    # window_feed, per call:
    #   1. COMMIT the in-flight window: read its rows, re-track weak or
    #      keyframe-to-be frames against the current map, insert keyframes
    #      (features + stereo landmarks + BoW registration);
    #   2. DISPATCH the next window's scan from the host's state (last
    #      frame, pose and the velocity of the committed poses, re-tracks
    #      included), so the scan runs on a map as fresh as its own first
    #      frame (the reference's one-keyframe mapping lag);
    #   3. run the committed keyframes' MAPPING work (triangulation, fuse,
    #      local BA, loop closing) behind the scan (System.py:58-64); pose
    #      refinements reach the in-flight window through its base
    #      correction at the next commit.

    def track_stereo_window(self, lefts, rights, timestamps) -> np.ndarray:
        """Track a window of W frames with one device dispatch
        (``tracking.fused_track_window``): the device carries features and
        pose from frame to frame; keyframe decisions and map updates run on
        the host after the window from the per-frame rows.  The local map
        is frozen for the window, the lag the reference's asynchronous
        LocalMapping thread produces.  Until initialized the frames go
        through the per-frame machine.  Returns the W per-frame Tcw."""
        return self._window_call(self.frame_id + 1, self._track_stereo_window_inner,
                                 lefts, rights, timestamps)

    def _track_stereo_window_inner(self, lefts, rights, timestamps):
        if self.state != "OK" or self.map.keyframes.n == 0:
            return self._window_bootstrap(lefts, rights, timestamps)
        return self._commit_window(
            self._dispatch_window(lefts, rights, timestamps))

    def _window_call(self, first: int, inner, *args) -> np.ndarray:
        """A call of the windowed schedule as the root span ``call.window``
        with ``first``, the id of the first frame the call hands in (the
        first it commits, for a flush), and the poses it made final
        (``returned``)."""
        with trace.span("call.window", first) as sp:
            out = inner(*args)
            if sp is not None:
                sp.args["returned"] = len(out)
            return out

    def _track_row(self, left, right, timestamp) -> np.ndarray:
        """One frame of a windowed call through the per-frame machine, as a
        ``window.row`` span with its own frame id."""
        with trace.span("window.row", self.frame_id + 1) as sp:
            if sp is not None:
                sp.args.update(perframe=1)
            return self.track_stereo(left, right, timestamp)

    def _window_bootstrap(self, lefts, rights, timestamps) -> np.ndarray:
        """Per-frame tracking until the system is initialized (or has
        recovered), then the rest of the window as one scan when it holds
        three frames or more."""
        L = len(timestamps)
        poses, i = [], 0
        while i < L and (self.state != "OK" or self.map.keyframes.n == 0):
            poses.append(self._track_row(lefts[i], rights[i], timestamps[i]))
            i += 1
        if L - i >= 3:
            poses.extend(self._commit_window(self._dispatch_window(
                lefts[i:], rights[i:], timestamps[i:])))
        else:
            for j in range(i, L):
                poses.append(self._track_row(lefts[j], rights[j], timestamps[j]))
        return np.stack(poses)

    def window_feed(self, lefts, rights, timestamps) -> np.ndarray:
        """Feed one window; returns the poses that became final with this
        call (usually the previous window's W; none on the first call; the
        pending window's and this one's when a bootstrap flushes).

        Operating envelope: the in-flight window scans against a map
        frozen up to 2W-1 frames ago, so the motion over a window must stay
        well inside the projection-search radius at scene depth (about
        2-3 m a window at KITTI-like depths).  Faster motion makes scanned
        rows anchor on landmarks their own drifted keyframes created; use
        ``track_stereo_async`` there."""
        # its frames come after the pending window's
        pending = self._pending_window
        first = self.frame_id + 1 + (
            len(pending["timestamps"]) if pending is not None else 0)
        return self._window_call(first, self._window_feed_inner,
                                 lefts, rights, timestamps)

    def _window_feed_inner(self, lefts, rights, timestamps):
        if self.state != "OK" or self.map.keyframes.n == 0:
            done = self._window_flush_inner()
            boot = self._window_bootstrap(lefts, rights, timestamps)
            return np.concatenate([done, boot]) if len(done) else boot

        old = self._pending_window
        self._pending_window = None
        out = np.zeros((0, 4, 4), np.float32)
        if old is not None:
            self._defer_maintenance = True
            try:
                out = self._commit_window(old)
            finally:
                self._defer_maintenance = False
            if self.state != "OK":
                # lost mid-window: the per-frame rescue machine took the
                # tail; drain the mapping work and track this window per
                # frame too
                self._run_maintenance_queue()
                return np.concatenate([out, np.stack([
                    self._track_row(lefts[i], rights[i], timestamps[i])
                    for i in range(len(timestamps))])])
        # the scan starts from the host's state as the commit left it: its
        # last frame, pose and velocity (the motion model of the poses it
        # committed, re-tracks included)
        new = self._dispatch_window(lefts, rights, timestamps)
        base_pre = self.Tcw.copy()
        self._pending_window = new
        # the committed keyframes' mapping work runs behind the scan
        self._run_maintenance_queue()
        # its pose refinements reach the in-flight window as a base
        # correction (the window's raw chain is anchored at base_pre)
        new["base"] = (base_pre, self.Tcw.copy())
        return out

    def window_flush(self) -> np.ndarray:
        """Commit the in-flight window, if any; returns its poses."""
        return self._window_call(self.frame_id + 1, self._window_flush_inner)

    def _window_flush_inner(self) -> np.ndarray:
        pending = self._pending_window
        self._pending_window = None
        if pending is None:
            return np.zeros((0, 4, 4), np.float32)
        if self.state != "OK":
            return np.stack([
                self._track_row(l, r, t) for l, r, t in zip(
                    pending["lefts"], pending["rights"], pending["timestamps"])])
        return self._commit_window(pending)

    def _dispatch_window(self, lefts, rights, timestamps):
        """Upload one window of stereo pairs and dispatch the scan, seeded
        with the host's last frame, its landmark assignment, pose and
        velocity.  Host-timed: the scan stays in flight.  Its span carries
        the window's first frame id (the frames before it are committed by
        now) and counts the window's frames, the carried features and the
        local map's points."""
        with self._t("window.dispatch", sync=False) as sp:
            if sp is not None:
                sp.frame = self.frame_id + 1
            pending = self._dispatch_window_inner(lefts, rights, timestamps)
            if sp is not None:
                sp.args.update(frames=len(timestamps), n_feat=pending["n_feat"],
                               n_local=pending["n_local"])
            return pending

    def _dispatch_window_inner(self, lefts, rights, timestamps):
        W = len(timestamps)
        local_ids = self._spatial_point_ids(self.Tcw)
        p_ids = self._pad_ids(local_ids)

        # one upload for the whole window, in the caller's dtype (uint8
        # where given: a quarter of float32's bytes)
        images = self._dev(np.stack([
            np.stack([np.asarray(lefts[i]), np.asarray(rights[i])])
            for i in range(W)]))
        frame0 = self.last_frame
        q_lm0 = self._dev(self._last_lm_ids())
        Tlw0 = self._dev(self.Tcw)
        Tllw0 = self._dev(
            (np.linalg.inv(self.velocity) @ self.Tcw).astype(np.float32))
        packed, frames, _ = fused_track_window(
            images, *self._landmark_mirror(), frame0, q_lm0,
            self._dev(p_ids), Tlw0, Tllw0, self.cfg,
            first_frame=self.frame_id + 1,
        )
        return dict(packed=HostRead(packed),   # the read overlaps the scan
                    frames=frames, frame0=frame0,
                    lefts=lefts, rights=rights, timestamps=timestamps,
                    p_ids=p_ids, n_local=len(local_ids),
                    n_feat=int(q_lm0.shape[0]), base=None)

    def _commit_window(self, pending) -> np.ndarray:
        """:meth:`_commit_window_inner` under the stage clock
        ``window.commit_total``, whose span carries the first row's frame
        id and the keyframes inserted (``kf``); the keyframe stages' time
        inside it is added to ``times[WINDOW_COMMIT_KF]``."""
        kf_side, n_kfs = self.times[KEYFRAME_SIDE], self.map.keyframes.n
        with self._t("window.commit_total") as sp:
            if sp is not None:
                sp.frame = self.frame_id + 1
            poses = self._commit_window_inner(pending)
            if sp is not None:
                sp.args["kf"] = self.map.keyframes.n - n_kfs
        self.times[WINDOW_COMMIT_KF] += self.times[KEYFRAME_SIDE] - kf_side
        return poses

    def _commit_window_inner(self, pending) -> np.ndarray:
        """Commit one scanned window frame by frame, each a ``window.row``
        span with its frame id.  A healthy row commits
        its scan pose.  A frame that needs a keyframe, or whose anchoring
        fell below ``window_commit_min_inliers``, is re-tracked on the
        device against the current map from the features the scan built.
        Only a frame still weak after that (true tracking loss) hands the
        rest of the window to the per-frame machine and its
        relocalization ladder.  The commit's span counts the rows
        (``frames``), the re-tracks (``retracked``), those the 28 px tier
        saved (``rescued_28px``) and the rows handed to the per-frame
        machine (``aborted``)."""
        commit_sp = trace.current()     # the commit's
        timestamps = pending["timestamps"]
        lefts, rights = pending["lefts"], pending["rights"]
        W = len(timestamps)
        with self._t("window.read", sync=False):
            out = pending["packed"].numpy()     # ONE device->host transfer
        frames = [pending["frame0"], *pending["frames"]]

        base_raw, base_corr = pending["base"] or (None, None)
        trk = self.cfg.tracking
        poses = []
        aborted = None
        retracks = rescued = 0

        def retrack(i, raw, want_snapshot=False):
            """Frame i re-tracked: (row, p_ids), or None when weak."""
            nonlocal retracks, rescued, base_raw, base_corr
            re, wide = self._retrack_window_frame(
                frames[i + 1], frames[i], want_snapshot=want_snapshot)
            retracks += 1
            rescued += re is not None and wide
            if re is not None and np.isfinite(raw).all():
                # the re-tracked pose leaves the raw scan chain: fold the
                # delta into the base correction so later rows follow.  A
                # non-finite raw (a diverged scan pose) never becomes the
                # base: later rows then rebase off the last finite one
                base_raw, base_corr = raw.copy(), re[0].Tcw.copy()
            return re

        self._mapper_queue = 0   # window commit = mapper busy
        for i in range(W):
            with trace.span("window.row", self.frame_id + 1) as row_sp:
                retracks_before = retracks
                row = read_row(out[i], pending["n_feat"], len(pending["p_ids"]))
                raw = row.Tcw
                if row.n_matches < 20 or row.n_in_motion < 20 \
                        or not np.isfinite(raw).all():
                    # motion tracking collapsed mid-scan (often a stale map in
                    # the pipelined schedule): re-anchor on the device against
                    # the current map; only a failed re-track falls back to the
                    # per-frame rescue
                    self.events.append("retrack:scan_weak")
                    re = retrack(i, raw)
                    if re is None:
                        aborted = i
                        self.events.append("abort:scan_weak")
                        break
                else:
                    Tcw_i = raw
                    if base_raw is not None:
                        # a singular base degrades to the per-frame rescue
                        # instead of aborting the whole commit
                        try:
                            Tcw_i = raw @ np.linalg.inv(base_raw) @ base_corr
                        except np.linalg.LinAlgError:
                            aborted = i
                            self.events.append("abort:singular_base")
                            break
                    re = (row._replace(
                        Tcw=np.ascontiguousarray(Tcw_i, dtype=np.float32),
                        assign=self._live_assign(row.assign)), pending["p_ids"])
                row, p_ids = re

                # does this frame need a keyframe, or did its anchoring weaken
                # below the commit bar?  The mapper is the reference's async
                # LocalMapping: idle once its per-keyframe latency has elapsed
                ks = self.map.keyframes
                needs_kf = need_new_keyframe(
                    n_inliers=int((row.assign >= 0).sum()),
                    n_ref_matches=self._ref_kf_tracked_points(),
                    n_kfs=int(ks.alive[: ks.n].sum()),
                    frame_id=self.frame_id + 1,
                    last_kf_frame=self.last_kf_frame,
                    last_reloc_frame=self.last_reloc_frame,
                    tracked_close=row.tracked_close,
                    non_tracked_close=row.non_tracked_close,
                    min_frames=trk.min_frames, max_frames=trk.max_frames,
                    mapper_idle=(self.frame_id + 1 >= self.last_kf_frame
                                 + trk.mapper_latency_frames),
                    queue_len=self._mapper_queue,
                )
                if retracks == retracks_before and (    # not re-tracked yet
                        needs_kf or row.n_in_local < self.window_commit_min_inliers):
                    # a keyframe-to-be is re-anchored against the current map
                    # before insertion (its landmarks seed what follows); the
                    # same dispatch brings its insertion snapshot and BoW
                    self.events.append(
                        "retrack:needs_kf" if needs_kf else "retrack:weak_anchor")
                    re = retrack(i, raw, want_snapshot=needs_kf)
                    if re is None:
                        # weak even against the current map: the per-frame
                        # machine's full rescue ladder takes this stretch
                        aborted = i
                        self.events.append("abort:retrack_failed")
                        break
                    row, p_ids = re

                self.frame_id += 1
                # a committed pose is rigid.  A scanned row composed with the
                # base correction is not quite, and the device treats every pose
                # it is given as rigid (``se3.inverse`` transposes): the next
                # window's velocity seed and the VO points then carry the
                # defect, and it grows window by window until the scan loses
                # track (ROADMAP queue 3, F4)
                row = row._replace(Tcw=_rigid(row.Tcw))
                self._adopt_row(frames[i + 1], row, p_ids, timestamps[i])
                if not np.allclose(self.Tcw, row.Tcw, atol=1e-7):
                    # local BA moved the pose: later rows follow the move
                    base_raw = raw.copy()
                    base_corr = self.Tcw.copy()
                self.trajectory.append(self.Tcw.copy())
                self._append_frame_ref()
                poses.append(self.Tcw.copy())
                if row_sp is not None:
                    row_sp.args.update(perframe=0,
                                       retracked=retracks - retracks_before)
        if aborted is not None:
            # true weakness: the per-frame machine (BoW fallback, wide
            # rescue, relocalization) takes the rest of the window
            for i in range(aborted, W):
                poses.append(
                    self._track_row(lefts[i], rights[i], timestamps[i]))
        if commit_sp is not None:
            commit_sp.args.update(
                frames=W, retracked=retracks, rescued_28px=rescued,
                aborted=0 if aborted is None else W - aborted)
        self._mapper_queue = None   # mapper idle again
        return np.stack(poses)

    def _retrack_window_frame(self, frame_i, frame_prev,
                              want_snapshot: bool = False):
        """The full tracking body (motion model + local map + pose
        optimization) for one scanned frame against the current map, from
        the features the scan built: the re-track before an in-window
        keyframe insertion.  With ``want_snapshot`` the same read also
        brings the insertion snapshot and BoW vectors (one read, not two).
        Returns ((``tracking.TrackRow``, the local map's padded ids), or
        None when weak; whether the 28 px tier ran).  Both attempts read
        back at once, as the synchronous schedule does.  Its span counts
        the search radius it ended with (``th``) and whether it held
        (``ok``)."""
        with self._t("window.retrack") as sp:
            re, wide = self._retrack_window_frame_inner(
                frame_i, frame_prev, want_snapshot)
            if sp is not None:
                sp.args.update(th=28.0 if wide else 7.0, ok=int(re is not None))
            return re, wide

    def _retrack_window_frame_inner(self, frame_i, frame_prev,
                                    want_snapshot: bool):
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        q_lm = self._last_lm_ids()
        p_ids = self._pad_ids(self._spatial_point_ids(Tcw_pred))
        voc = self.vocabulary
        want_snapshot = want_snapshot and voc is not None
        args = (frame_i, *self._landmark_mirror(), q_lm, frame_prev, p_ids,
                Tcw_pred, self.Tcw, self.cfg)

        def attempt(th_base):
            row, _, _ = fused_retrack_step(*args, th_base=th_base)
            out = row
            if want_snapshot:
                out = torch.cat([row, graphed_snapshot(
                    frame_i, voc._device_arrays(self.device), voc.k, voc.L,
                    voc.feature_levels_up)[0]])
            out = out.cpu().numpy()
            return read_row(out, len(q_lm), len(p_ids)), out[len(row):]

        def weak(row):
            return row.n_matches < 20 or row.n_in_motion < 20 \
                or row.n_in_local < 20

        row, snap = attempt(7.0)
        wide = weak(row)
        if wide:
            # the wide-radius rescue (the per-frame ladder's 28 px tier,
            # Tracking.py's 2*th retry) before giving up on the frame
            row, snap = attempt(28.0)
        if weak(row):
            return None, wide
        if want_snapshot:
            self._adopt_snapshot(frame_i, snap)
        return (row, p_ids), wide

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
        """KITTI 3x4 row-major camera->world format, one line per frame
        (``io.kitti.save_trajectory_kitti``)."""
        save_trajectory_kitti(path, self.corrected_trajectory())

    def activate_localization_mode(self):
        """Freeze the map (reference System.py:106-112 stops LocalMapping):
        drain in-flight frames and staged mapping work first so the frozen
        map is consistent, then suppress keyframe creation.  Odometry
        survives unmapped excursions through the hybrid VO queries of the
        fused step (the reference's temporal VO points,
        Tracking.py:612-659)."""
        self.flush_async()
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def shutdown(self):
        """Drain all in-flight work so every fed frame lands in the
        trajectory (System.py:149-167 joins its threads): the pipelined
        schedule's uncommitted frame, a pending window and the staged
        keyframe-maintenance queue; on a CUDA device the queued kernels
        are waited for.  Idempotent."""
        self.flush_async()
        self.window_flush()
        self._run_maintenance_queue()
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
        if force:
            self._mirror_stale = True
        if self._mirror is not None and not self._mirror_stale:
            return self._mirror
        with trace.span("track.mirror") as sp:
            rows = self._refresh_mirror()
            if sp is not None:
                sp.args["rows"] = rows
        return self._mirror

    def _refresh_mirror(self) -> int:
        """Bring the mirror up to the store; returns the rows uploaded."""
        lm = self.map.landmarks
        cap = 1 << 14
        while cap < lm.n:
            cap <<= 1
        cap = min(cap, lm.capacity)

        def full_upload():
            host = tuple(getattr(lm, f)[:cap] for f in _MIRROR_FIELDS)
            # torch.tensor copies: the mirror must not alias the store
            self._mirror = tuple(self._dev(torch.tensor(h)) for h in host)
            self._mirror_shadow = tuple(h.copy() for h in host)
            self._mirror_cap = cap
            # shadow now equals host: all dirt is accounted for
            lm.drain_dirty()
            self.map.core.drain_dirty()
            self._mirror_pending = np.empty(0, np.int32)

        rows = 0
        if self._mirror is None or self._mirror_cap != cap:
            full_upload()
            rows = cap
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
                rows = cap
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
                rows = pad
        self._mirror_stale = False
        return rows

    def _track_fused(self, left, right, timestamp: float):
        """Fast path: the whole per-frame hot path as one device program
        (tracking.fused_track_chain_step) + one packed read-back.  Weak
        tracking goes to the step-by-step host path."""
        with self._t("perframe.track") as sp:
            if sp is not None:
                sp.frame = self.frame_id
            return self._track_fused_inner(left, right, timestamp)

    def _track_fused_inner(self, left, right, timestamp: float):
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        q_lm = self._last_lm_ids()
        p_ids = self._pad_ids(self._local_point_ids(self.last_assign))
        row, frame = fused_track_chain_step(
            left, right, *self._landmark_mirror(), self.last_frame,
            q_lm, Tcw_pred, self.Tcw, p_ids, self.cfg,
        )
        # ONE device->host transfer
        row = read_row(row.cpu().numpy(), len(q_lm), len(p_ids))
        if row.n_matches < 20 or row.n_in_motion < 20 or row.n_in_local < 10:
            # weak tracking: rerun through the host state machine
            self.events.append("sync:weak")
            return self._track(frame, timestamp)
        self._adopt_row(frame, row, p_ids, timestamp)

    def _track(self, frame: StereoFrame, timestamp: float):
        lm = self.map.landmarks
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        lm_ids = self._last_lm_ids()
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
        p_ids = self._pad_ids(local_ids)
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

        self._count_tracked(assign, p_ids[lres.p_visible.cpu().numpy()])

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
                queue_len=self._mapper_queue or 0,
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
        dropped); consumed lazily by :meth:`_frame_host`.  A
        ``track.prefetch`` span whose ``graph`` is 1 when the program
        replayed its CUDA graph, 0 when it ran eagerly."""
        if self.vocabulary is None:
            return
        if self._snap_prefetch is not None and self._snap_prefetch[0] is frame:
            return
        with trace.span("track.prefetch") as sp:
            voc = self.vocabulary
            buf, replayed = graphed_snapshot(
                frame, voc._device_arrays(self.device), voc.k, voc.L,
                voc.feature_levels_up)
            self._snap_prefetch = (frame, HostRead(buf))   # copy starts now
            if sp is not None:
                sp.args["graph"] = int(replayed)

    def _frame_host(self, frame: StereoFrame) -> dict:
        """Host snapshot of a frame's per-feature arrays, pulled in ONE
        device->host transfer and cached per frame object."""
        if self._frame_cache is not None and self._frame_cache[0] is frame:
            return self._frame_cache[1]
        if self._snap_prefetch is not None and self._snap_prefetch[0] is frame:
            with self._t("kf.snapshot_read"):
                buf = self._snap_prefetch[1].numpy()
            return self._adopt_snapshot(frame, buf)
        snap = unpack_frame_np(pack_frame(frame).cpu().numpy(), frame.capacity)
        self._frame_cache = (frame, snap)
        return snap

    def _adopt_snapshot(self, frame: StereoFrame, buf: np.ndarray) -> dict:
        """Cache a ``kf_snapshot`` buffer read back for ``frame``: its host
        arrays and BoW vectors, so insertion reads nothing more; returns
        the host arrays."""
        snap, vocab = read_snapshot(buf, frame.capacity)
        self._frame_cache = (frame, snap)
        self._vocab_cache = (frame, vocab)
        self._snap_prefetch = None
        return snap

    def _insert_keyframe(self, frame: StereoFrame, assign: np.ndarray,
                         timestamp: float, run_ba: bool):
        with self._t("kf.insert_total") as sp:
            if sp is not None:
                sp.frame = self.frame_id
            kf = self._insert_keyframe_inner(frame, assign, timestamp, run_ba)
            if sp is not None:
                sp.args["kf"] = kf
            return kf

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
        if self.loop_closer is None and self.enable_loop_closing:
            self.loop_closer = LoopCloser(
                self.cfg, self.map, self.vocabulary, self.kfdb)
        if self.local_mapper is None:
            self.local_mapper = LocalMapper(
                self.cfg, self.map,
                ring=self.kf_ring, mirror_fn=self._landmark_mirror)
        new_ids = assign[(assign >= 0) & (self.lm_created_kf[np.maximum(assign, 0)] < 0)]
        self.lm_created_kf[new_ids] = kf
        self.recent_lms.append(np.unique(assign[assign >= 0]))
        self.last_kf_frame = self.frame_id
        if self._mapper_queue is not None:
            self._mapper_queue += 1

        # map-point culling over landmarks created in the last 3 KFs
        if len(self.recent_lms) > 3:
            self.map.cull_map_points(
                self.recent_lms[-3], kf, self.lm_created_kf
            )

        self._mirror_stale = True   # the store changed; re-upload lazily
        if run_ba:
            if self._defer_maintenance:
                # pipelined schedule: the mapping work for this keyframe
                # (triangulation / fuse / BA) runs AFTER the next frame's
                # tracking step is dispatched: the reference's
                # asynchronous LocalMapping lag (LocalMapping.py:43-84)
                self._maint_queue.append((kf, bow))
            else:
                self._kf_maintenance(kf, bow, deferred=False)
        return kf

    def _kf_maintenance(self, kf: int, bow, deferred: bool):
        """LocalMapping + LoopClosing work for one keyframe
        (LocalMapping.run order: triangulate new points over covisible
        neighbors, fuse duplicates, local BA, keyframe culling, then the
        loop-closing stage).  ``deferred`` = running after later frames
        were already tracked: pose refinements fold into the live pose as
        a rigid delta instead of being adopted directly."""
        if self.local_mapper is not None:
            # triangulation + both fuse directions as ONE device program
            # + ONE packed read (LocalMapper.maintain)
            with self._t("kf.maintain") as sp:
                self._kf_span(sp, kf)
                info = self.local_mapper.maintain(kf)
            self.events.append(("maintain", kf, info))

        if kf % self.ba_every_n_kf == 0:
            pre = self.map.keyframes.Tcw[kf].copy()
            with self._t("kf.local_ba") as sp:
                self._kf_span(sp, kf)
                info = self.map.local_ba(kf)
            self.events.append(("local_ba", kf, info))
            if info.get("ran"):
                if deferred:
                    delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(pre)
                    self.Tcw = (delta @ self.Tcw).astype(np.float32)
                else:
                    # adopt the BA-refined pose for the current camera
                    self.Tcw = self.map.keyframes.Tcw[kf].copy()

        self._cull_keyframes(kf)
        self._loop_stage(kf, bow, adopt=not deferred, sync=True)
        self._mirror_stale = True

    def _loop_stage(self, kf: int, bow, adopt: bool, sync: bool):
        """The loop closer on one keyframe, then (if it closed nothing) one
        pending global-BA slice.  A slice's or a closure's correction of
        ``kf`` folds into the live pose as a rigid delta; with ``adopt`` a
        closure's corrected keyframe pose is taken as it is.  A closure
        also clears the motion model (the old velocity lives in the
        pre-correction frame).  ``sync=False`` in the pipelined queue: the
        stage reads its own results, and a timer that waited would also
        wait for the frame dispatched just before."""
        if self.loop_closer is None:
            return
        pre = self.map.keyframes.Tcw[kf].copy()
        with self._t("kf.loop", sync=sync) as sp:
            self._kf_span(sp, kf)
            closed = self.loop_closer.on_keyframe(kf, bow)
        self.events.append(("loop", kf, closed))
        ran_slice = False
        if not closed:
            with self._t("kf.gba_slice", sync=sync) as sp:
                self._kf_span(sp, kf)
                ran_slice = self.loop_closer.run_gba_slice()
        if closed and adopt:
            self.Tcw = self.map.keyframes.Tcw[kf].copy()
        elif closed or ran_slice:
            delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(pre)
            self.Tcw = (delta @ self.Tcw).astype(np.float32)
        if closed:
            self.velocity = np.eye(4, dtype=np.float32)

    def _run_maintenance_queue(self, blocking: bool = True):
        """Advance the deferred per-keyframe mapping work.

        Each keyframe's mapping pass is a little pipeline:
        maintain-dispatch -> maintain-apply -> BA-dispatch -> BA-apply ->
        culling.  The pipelined schedule advances every in-flight
        keyframe ONE device stage per tracked frame (``blocking=False``):
        a stage's read happens one frame after its dispatch, so it
        overlaps the device's next tracking step.  The flush paths run
        the pipe to completion (``blocking=True``).  Pose refinements
        fold into the live pose as rigid deltas (the reference's async
        LocalMapping lag, LocalMapping.py:43-84)."""
        for kf, bow in self._maint_queue:
            self._maint_pipe.append(dict(
                kf=kf, bow=bow, stage="new", pend=None, ba_pend=None,
                pre=None))
        self._maint_queue = []
        while self._maint_pipe:
            for it in list(self._maint_pipe):
                self._advance_maint_item(it)
                if it["stage"] == "done":
                    self._maint_pipe.remove(it)
            if not blocking:
                break

    def _advance_maint_item(self, it):
        kf = it["kf"]
        lmapper = self.local_mapper
        if it["stage"] == "new":
            if lmapper is None:
                it["stage"] = "maint_done"
                return
            with self._t("kf.maintain_dispatch", sync=False) as sp:
                self._maint_span(sp, it)
                it["pend"] = lmapper.maintain_dispatch(kf)
                if sp is not None:
                    sp.args["graph"] = int(it["pend"] is not None
                                           and it["pend"]["graph"])
            if it["pend"] is None:
                # ring rotated a participant out: separate-step fallback
                # (its own reads wait for its results; the timer must not
                # also wait for the frame dispatched just before)
                with self._t("kf.maintain", sync=False) as sp:
                    self._maint_span(sp, it)
                    info = dict(new=lmapper.create_new_points(kf),
                                fused=lmapper.fuse_neighbors(kf),
                                fallback=True)
                self.events.append(("maintain", kf, info))
                self._mirror_stale = True
                it["stage"] = "maint_done"
                return
            it["stage"] = "maint_dispatched"
            return
        if it["stage"] == "maint_dispatched":
            # the packed read has been copying since its dispatch a frame
            # ago; one still in flight is waited for here and never put off
            # to a later frame (the JAX package's ``_handle_pending`` puts
            # it off), so the schedule and the map it builds do not depend
            # on how fast the host ran
            with self._t("kf.maintain_apply", sync=False) as sp:
                self._maint_span(sp, it, it["pend"]["handle"])
                info = lmapper.maintain_apply(it["pend"])
            self.events.append(("maintain", kf, info))
            self._mirror_stale = True
            it["stage"] = "maint_done"
            return
        if it["stage"] == "maint_done":
            if kf % self.ba_every_n_kf == 0:
                it["pre"] = self.map.keyframes.Tcw[kf].copy()
                with self._t("kf.ba_dispatch", sync=False) as sp:
                    self._maint_span(sp, it)
                    r = self.map.local_ba(kf, split=True)
                if r.get("pending") is not None:
                    it["ba_pend"] = r["pending"]
                    it["stage"] = "ba_dispatched"
                    return
                self.events.append(("local_ba", kf, r))
            it["stage"] = "post_ba"
            return self._advance_maint_item(it)
        if it["stage"] == "ba_dispatched":
            # read one frame after its dispatch, as the maintain stage's
            with self._t("kf.ba_apply", sync=False) as sp:
                self._maint_span(sp, it, it["ba_pend"]["handle"])
                info = self.map.local_ba_apply(it["ba_pend"])
            self.events.append(("local_ba", kf, info))
            delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(it["pre"])
            self.Tcw = (delta @ self.Tcw).astype(np.float32)
            self._mirror_stale = True
            it["stage"] = "post_ba"
            return self._advance_maint_item(it)
        if it["stage"] == "post_ba":
            self._cull_keyframes(kf)
            self._loop_stage(kf, it["bow"], adopt=False, sync=False)
            self._mirror_stale = True
            it["stage"] = "done"

    def _kf_span(self, sp, kf: int):
        """A keyframe stage's span (None while tracing is off) gets the id
        of the frame that made the keyframe, before anything inside it
        opens a span, and the keyframe as a counter."""
        if sp is not None:
            sp.frame = int(self.map.keyframes.frame_id[kf])
            sp.args["kf"] = kf

    def _maint_span(self, sp, it, read: Optional[HostRead] = None):
        """:meth:`_kf_span` for a mapping-pipe stage, with the items in the
        pipe and, for a read, whether it was still in flight (``pending``:
        the host waits for it)."""
        if sp is None:
            return
        self._kf_span(sp, it["kf"])
        sp.args["pipe_depth"] = len(self._maint_pipe)
        if read is not None:
            sp.args["pending"] = int(read.pending())

    def _cull_keyframes(self, kf: int):
        """Keyframe culling, every 4th keyframe."""
        if self.local_mapper is None or kf % 4 != 0:
            return
        with trace.span("kf.cull") as sp:
            self._kf_span(sp, kf)
            self.local_mapper.cull_keyframes(
                kf, on_removed=lambda k: self.kfdb.erase(k))

    # ---------------- reference-keyframe tracking ----------------

    def _stereo_edges(self, frame: StereoFrame, assign: np.ndarray):
        """Pose-optimization inputs over a frame's assigned features:
        (Xw, obs (u, v, u_right), edge_active) as host arrays."""
        xy = frame.xy.cpu().numpy()
        u_right = frame.u_right.cpu().numpy()
        Xw = self.map.landmarks.pos[np.maximum(assign, 0)]
        obs = np.stack([xy[:, 0], xy[:, 1], u_right], 1)
        edge_active = (assign >= 0) & (u_right > 0) & frame.valid.cpu().numpy()
        return Xw, obs, edge_active

    def _cam5(self) -> torch.Tensor:
        c = self.cfg.camera
        return self._dev(np.asarray([c.fx, c.fy, c.cx, c.cy, c.bf], np.float32))

    def _track_reference_keyframe(self, frame: StereoFrame):
        """Tracking.track_reference_key_frame (Tracking.py:329-356): BoW-match
        the current frame against its REFERENCE keyframe (the one its
        relative-pose log anchors to: after relocalizing into an old map
        region this is the old-region keyframe, not the newest one) with
        the 0.7 ratio test at TH_LOW plus rotation consistency
        (ORBMatcher.search_by_BoW_kf_f:21-118), seed the pose from the last
        frame, run motion-only optimization; accepted at >= 10 inliers.
        Falls back to the newest keyframe if the reference is unavailable.
        Returns (Tcw, assign) or None."""
        ks = self.map.keyframes
        kf = ks.n - 1
        if self.frame_refs and self.frame_refs[-1][0] >= 0:
            ref, _ = self.map.resolve_ref(
                self.frame_refs[-1][0], np.eye(4, dtype=np.float32))
            if 0 <= ref < ks.n and ks.alive[ref]:
                kf = ref
        if kf < 0 or self.vocabulary is None:
            return None
        lm = self.map.landmarks
        kf_lm = lm.resolve(ks.obs_lm[kf])
        q_active = (kf_lm >= 0) & lm.alive[np.maximum(kf_lm, 0)]
        if q_active.sum() < 15:
            return None
        _, _, node = self.vocabulary.transform(
            frame.desc, levels_up=self.vocabulary.feature_levels_up)
        idx, matched = match_ops.bow_match_rot(
            self._dev(ks.kp_desc[kf]), self._dev(ks.kp_node[kf]),
            self._dev(q_active),
            frame.desc_bits, popcount(frame.desc), self._dev(node),
            frame.valid,
            self._dev(ks.kp_angle[kf]), frame.angle,
        )
        matched_np = matched.cpu().numpy()
        if matched_np.sum() < 15:
            return None
        idx_np = idx.cpu().numpy()
        qi = np.nonzero(matched_np)[0]
        assign = np.full(frame.capacity, -1, np.int32)
        assign[idx_np[qi]] = kf_lm[qi]

        Xw, obs, edge_active = self._stereo_edges(frame, assign)
        inv_sigma2 = np.asarray(self.cfg.orb.inv_level_sigma2)[
            frame.octave.cpu().numpy()]
        pres = pose_opt.pose_optimization(
            self._dev(self.Tcw), self._dev(Xw), self._dev(obs),
            self._dev(inv_sigma2), self._dev(edge_active), self._cam5(),
            rounds=self.cfg.ba.pose_rounds,
            iters=self.cfg.ba.pose_iters_per_round,
        )
        if int(pres.num_inliers) < 10:
            return None
        inl = pres.inliers.cpu().numpy()
        assign = np.where(edge_active & ~inl, -1, assign).astype(np.int32)
        return pres.Tcw.cpu().numpy(), assign

    # ---------------- relocalization ----------------

    def _relocalize(self, frame: StereoFrame):
        """Tracking.relocalization (Tracking.py:661-763): BoW candidates ->
        BoW matching (>=15) -> batched EPnP RANSAC -> pose optimization,
        accepted at >=50 stereo inliers after a final refinement.
        Returns (Tcw, assign) or None when no candidate holds."""
        if self.kfdb is None or self.map.keyframes.n == 0:
            return None
        frame_valid = frame.valid.cpu().numpy()
        word, wweight, node = self.vocabulary.transform(
            frame.desc, levels_up=self.vocabulary.feature_levels_up)
        qbow = self.vocabulary.bow_vector(word, wweight, frame_valid)
        cands = self.kfdb.detect_relocalization_candidates(
            qbow, self.map.covisible_neighbors
        )[:5]
        if not cands:
            return None

        f_pop = popcount(frame.desc)
        f_node = self._dev(node)
        f_xy_all = frame.xy.cpu().numpy()
        f_oct_all = frame.octave.cpu().numpy()
        c = self.cfg.camera
        cam4 = self._dev(np.asarray([c.fx, c.fy, c.cx, c.cy], np.float32))
        sigma2 = np.asarray(self.cfg.orb.level_sigma2)
        inv_sigma2_feat = np.asarray(self.cfg.orb.inv_level_sigma2)[f_oct_all]
        # the minimal sets are drawn from the frame's number, as the JAX
        # package seeds its key; the two generators give other bits
        generator = torch.Generator(device=self.device)
        generator.manual_seed(max(self.frame_id, 0))
        lm = self.map.landmarks

        for kf in cands:
            ks = self.map.keyframes
            kf_lm = ks.obs_lm[kf]
            q_active = kf_lm >= 0
            idx, _, matched = match_ops.bow_match(
                self._dev(ks.kp_desc[kf]), self._dev(ks.kp_node[kf]),
                self._dev(q_active),
                frame.desc_bits, f_pop, f_node, frame.valid,
            )
            matched = matched.cpu().numpy()
            idx = idx.cpu().numpy()
            if matched.sum() < 15:
                continue
            # correspondences: frame feature -> landmark world pos
            qi = np.nonzero(matched)[0]
            fi = idx[qi]
            lm_ids = lm.resolve(kf_lm[qi])
            ok = lm_ids >= 0
            qi, fi, lm_ids = qi[ok], fi[ok], lm_ids[ok]
            if len(qi) < 15:
                continue
            Xw = lm.pos[lm_ids]
            f_xy = f_xy_all[fi]
            f_oct = f_oct_all[fi]

            # bucket-pad the correspondence count so the RANSAC program
            # keeps a few shapes (64, 128, ...)
            n = len(qi)
            B = 64
            while B < n:
                B <<= 1
            pad = B - n

            def _p(a, fill=0.0):
                return np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) \
                    if pad else a

            res = epnp_ransac(
                self._dev(_p(Xw)), self._dev(_p(f_xy)),
                self._dev(_p(sigma2[f_oct], 1.0)),
                self._dev(np.arange(B) < n), cam4, generator,
            )
            if not bool(res.ok):
                continue
            Tcw0 = np.eye(4, dtype=np.float32)
            Tcw0[:3, :3] = res.R.cpu().numpy()
            Tcw0[:3, 3] = res.t.cpu().numpy()

            # motion-only refinement over the matched set
            assign = np.full(frame.capacity, -1, np.int32)
            assign[fi] = lm_ids
            Xw_full, obs, edge_active = self._stereo_edges(frame, assign)
            pres = pose_opt.pose_optimization(
                self._dev(Tcw0), self._dev(Xw_full), self._dev(obs),
                self._dev(inv_sigma2_feat), self._dev(edge_active),
                self._cam5(),
            )
            n_good = int(pres.num_inliers)
            if n_good < 10:
                continue
            inl = pres.inliers.cpu().numpy()
            assign = np.where(edge_active & ~inl, -1, assign).astype(np.int32)
            Tcw_cur = pres.Tcw.cpu().numpy()

            # two-tier projection rescue (Tracking.py:724-755): project the
            # candidate KF's landmarks with the coarse pose and re-match:
            # first wide (th=10, ORBdist=100), then, if still marginal,
            # tight (th=3, ORBdist=64); each tier re-runs pose optimization
            # (folded into local_track_step).  Accept at >= 50 inliers.
            kf_pts = lm.resolve(kf_lm)
            kf_pts = np.unique(kf_pts[kf_pts >= 0])
            kf_pts = kf_pts[lm.alive[kf_pts]]
            p_ids = self._pad_ids(kf_pts)
            p_safe = np.maximum(p_ids, 0)

            def rescue(assign, Tcw_np, radius_mult, max_dist_th):
                lres = local_track_step(
                    frame,
                    self._dev(lm.pos[np.maximum(assign, 0)]),
                    self._dev(assign >= 0),
                    self._dev(lm.pos[p_safe]),
                    self._dev(lm.desc[p_safe]),
                    self._dev(lm.normal[p_safe]),
                    self._dev(lm.dmin[p_safe]),
                    self._dev(lm.dmax[p_safe]),
                    self._dev(p_ids >= 0),
                    self._dev(Tcw_np),
                    self.cfg,
                    radius_mult=radius_mult, max_dist_th=max_dist_th,
                )
                feat_local = lres.feat_local.cpu().numpy()
                tracked = lres.tracked.cpu().numpy()
                new_assign = np.where(
                    feat_local >= 0, p_ids[np.maximum(feat_local, 0)], assign
                )
                new_assign = np.where(tracked, new_assign, -1).astype(np.int32)
                return int(lres.n_inliers), lres.Tcw.cpu().numpy(), new_assign

            if n_good < 50:
                n_good, Tcw_cur, assign = rescue(assign, Tcw_cur, 10.0, 100)
                if 30 < n_good < 50:
                    n_good, Tcw_cur, assign = rescue(assign, Tcw_cur, 3.0, 64)
            if n_good < 50:
                continue
            return Tcw_cur, assign
        return None

    # ---------------- helpers ----------------

    def _last_lm_ids(self) -> np.ndarray:
        """The last frame's landmark id per feature, merges followed: what
        the next tracking step queries."""
        return self.map.landmarks.resolve(self.last_assign)

    def _pad_ids(self, ids: np.ndarray) -> np.ndarray:
        """Local-map ids padded with -1 to their capacity bucket
        (:func:`_cap_bucket`), the device programs' ``p_ids``."""
        cap = _cap_bucket(len(ids), self.cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(ids)] = ids[:cap]
        return p_ids

    def _live_assign(self, assign: np.ndarray) -> np.ndarray:
        """A deferred row's landmark ids against the map as it is now:
        merges followed, dead landmarks dropped (-1)."""
        lm = self.map.landmarks
        assign = lm.resolve(assign)
        return np.where(
            (assign >= 0) & lm.alive[np.maximum(assign, 0)], assign, -1)

    def _count_tracked(self, assign: np.ndarray, vis_ids: np.ndarray):
        """The found / visible counters (track_local_map's bookkeeping):
        the local points that passed the frustum gate (``vis_ids``, -1 pads
        skipped) were visible, the landmarks the frame tracked were found
        and visible."""
        lm = self.map.landmarks
        lm.visible[vis_ids[vis_ids >= 0]] += 1
        found_ids = np.unique(assign[assign >= 0])
        lm.found[found_ids] += 1
        lm.visible[found_ids] += 1

    def _adopt_row(self, frame: StereoFrame, row: TrackRow, p_ids: np.ndarray,
                   timestamp: float):
        """Commit a healthy tracked frame's row, tracked against the local
        map ``p_ids``: the found / visible counters, its state and pose,
        then the keyframe decision (:meth:`_finish_track`)."""
        self._count_tracked(row.assign, p_ids[row.p_visible])
        self.state = "OK" if row.n_in_local >= 20 else "MARGINAL"
        self.Tcw = row.Tcw
        self._finish_track(
            frame, row.assign, row.n_matches, row.n_in_local,
            row.tracked_close, row.non_tracked_close,
            int((p_ids >= 0).sum()), timestamp,
        )

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

    @trace.spanned("track.local_ids")
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
