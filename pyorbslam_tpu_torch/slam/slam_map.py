"""SlamMap: keyframes + landmarks + observations + covisibility + local BA.

Port of ``pyorbslam_tpu/slam/slam_map.py``.  The host-side map backend
(the array redesign of Map.py / KeyFrame.py / MapPoint.py bookkeeping)
plus the device-side Schur BA invocation.  The pointer-chasing
structures, the landmark->observer inverse index and the covisibility
weights, live in the native map core (native/mapcore.cpp), which
attaches directly to the numpy stores (obs_lm, u_right, n_obs, alive,
...) so there is exactly one owner of observation state.  Python keeps
only the tiny spanning-tree / loop-edge dicts, and the BA problem is
assembled natively into bucketed fixed-shape arrays dispatched to the
batched Schur LM engine on ``device``.

Reference semantics preserved:
  * covisibility edges at weight >= 15, ordered descending
    (KeyFrame.update_connections:145-203; the reference's
    update_best_covisibles ascending-sort bug is deliberately fixed);
  * local BA neighborhood: the KF + its covisibles free, second-ring
    observers fixed, KF 0 always fixed (Optimizer.py:210-260);
  * observation erasure after BA outlier gating (Optimizer.py:336-353),
    landmarks dying when support collapses (MapPoint.erase_observation);
  * map-point culling by found/visible ratio < 0.25 or weak early
    support (LocalMapping.map_point_culling:125-150);
  * normal/depth refresh after BA (MapPoint.update_normal_and_depth).

Global BA (:meth:`SlamMap.global_ba`, run by the loop closer) keeps the
JAX package's engine ladder: the dense grid engine up to 96 live
keyframes, the implicit-Schur CG engine (``optim/ba_cg.py``) above, and
above that, where several CUDA devices are visible, the same CG engine
sharded over a device mesh (``parallel/dist_ba.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.config import SlamConfig
from pyorbslam_tpu_torch.native.mapcore_ffi import MapCore
from pyorbslam_tpu_torch.ops.orb_descriptor import to_int32_bits
from pyorbslam_tpu_torch.optim import ba, ba_cg
from pyorbslam_tpu_torch.slam.mapstore import KeyFrameStore, LandmarkStore
from pyorbslam_tpu_torch.utils import trace
from pyorbslam_tpu_torch.utils.cuda_graph import GraphedProgram
from pyorbslam_tpu_torch.utils.host_read import HostRead, device_constant, upload
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls

COVIS_TH = 15

CAM_BUCKETS = (8, 16, 32, 64, 128, 256)
PNT_BUCKETS = (1024, 2048, 4096, 8192, 16384, 32768, 65536)
OBS_BUCKETS = (4096, 8192, 16384, 32768, 65536, 131072, 262144)
# the CG engine's buckets: a whole map is never truncated to the dense caps
CG_CAM_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
CG_PNT_BUCKETS = (16384, 32768, 65536, 131072, 262144)
CG_OBS_BUCKETS = (65536, 131072, 262144, 524288, 1048576)
GBA_DENSE_MAX_KFS = 96


def _pack_ba_result(cam_Tcw, pnt_pos, inlier):
    """BA write-back in one int32 buffer (one device->host read instead
    of three): [cam_Tcw bits 16C | pnt_pos bits 3P | inlier bits O/32];
    the inlier mask is bit-packed."""
    bits = inlier.to(torch.int64).reshape(-1, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=inlier.device)
    words = to_int32_bits((bits << shifts[None, :]).sum(dim=1))
    return torch.cat([
        cam_Tcw.contiguous().view(torch.int32).reshape(-1),
        pnt_pos.contiguous().view(torch.int32).reshape(-1),
        words,
    ])


def _dense_ba_body(cam_Tcw, cam_fixed, pnt_pos, pnt_active, g_cam, g_uvrq,
                   g_oct, g_act, cam, isig_table, iters1: int,
                   iters2: int) -> torch.Tensor:
    """The dense local-BA solve on the packed grid upload, its result
    packed for one read (:func:`_pack_ba_result`).  No host read and no
    upload, so a CUDA graph can capture it."""
    res = ba.bundle_adjust_grid_packed(
        cam_Tcw, cam_fixed, pnt_pos, pnt_active, g_cam, g_uvrq, g_oct, g_act,
        cam, isig_table, iters1=iters1, iters2=iters2)
    return _pack_ba_result(res.cam_Tcw, res.pnt_pos, res.g_inlier.reshape(-1))


# the dense solve's graphs, for the life of the process: keyed on its
# buckets (C, P, K) and iteration counts, so a shape met once (global BA
# after a loop closure) stays eager
DENSE_BA = GraphedProgram("ba.solve_capture")


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class SlamMap:
    cfg: SlamConfig
    device: torch.device
    landmark_capacity: int = 1 << 18
    keyframe_capacity: int = 4096

    def __post_init__(self):
        use_f32_matmuls()
        self.device = torch.device(self.device)
        self.landmarks = LandmarkStore(self.landmark_capacity)
        self.keyframes = KeyFrameStore(
            self.keyframe_capacity, self.cfg.orb.max_keypoints
        )
        self.times = defaultdict(float)   # BA-stage wall clock (seconds)
        self.counters = defaultdict(int)  # BA-stage event counts
        self.core = self._make_core()
        # spanning tree (parent = strongest covisible at insertion)
        self.parent: Dict[int, int] = {}
        self.children: Dict[int, set] = {}
        self.loop_edges: Dict[int, set] = {}
        # culled keyframes: kf -> (live-parent-at-cull, Tcp) where
        # Tcp = Tcw_kf @ inv(Tcw_parent) frozen at cull time: the
        # reference's KeyFrame.mTcp (KeyFrame.py:411), chained by
        # System.save_trajectory_kitti through dead ancestors
        # (System.py:124-145) so frame export survives keyframe culling
        self.dead_anchor: Dict[int, Tuple[int, np.ndarray]] = {}

    def _make_core(self) -> MapCore:
        ks, lm = self.keyframes, self.landmarks
        return MapCore(ks.obs_lm, ks.u_right, ks.kp_octave, lm.n_obs,
                       lm.alive, lm.replaced_by, lm.found, lm.visible)

    def rebuild_core(self):
        """Rebuild the native index from the dense obs_lm table (used by
        checkpoint restore).  n_obs is recounted from scratch."""
        self.landmarks.n_obs[:] = 0
        self.core = self._make_core()
        for kf in range(self.keyframes.n):
            if self.keyframes.alive[kf]:
                self.core.add_keyframe(kf)
        for kf in range(self.keyframes.n):
            if self.keyframes.alive[kf]:
                self.update_connections(kf)

    def resolve_ref(self, kf: int, Tcr: np.ndarray):
        """Chain a frame's (ref-KF, Tcr) through culled ancestors to the
        nearest LIVE keyframe (System.py:124-145 while-is-bad loop).
        Returns (live_kf, Tcr') with Tcr' @ Tcw[live_kf] == frame pose."""
        while kf in self.dead_anchor:
            parent, Tcp = self.dead_anchor[kf]
            if parent == kf:    # orphan cull (KF 0): nothing to chain to
                break
            Tcr = Tcr @ Tcp
            kf = parent
        return kf, Tcr

    # ------------- keyframe insertion -------------

    def add_keyframe(self, frame_np: dict, Tcw: np.ndarray, assign: np.ndarray,
                     frame_id: int, timestamp: float,
                     kp_node: Optional[np.ndarray] = None) -> int:
        """frame_np: dict of numpy arrays (xy, octave, angle, desc, valid,
        u_right, depth); assign: (N,) landmark id per feature (-1 = none)."""
        kf = self.keyframes.add(
            Tcw=Tcw, frame_id=frame_id, timestamp=timestamp,
            kp_xy=frame_np["xy"], kp_octave=frame_np["octave"],
            kp_angle=frame_np["angle"], kp_desc=frame_np["desc"],
            kp_valid=frame_np["valid"], u_right=frame_np["u_right"],
            depth=frame_np["depth"], obs_lm=assign.astype(np.int32),
            kp_node=kp_node,
        )
        self.core.add_keyframe(kf)
        self.update_connections(kf)
        return kf

    def update_connections(self, kf: int):
        """Recount shared-landmark weights for ``kf`` (KeyFrame.py:145-203)
        in the native core; maintain the spanning tree here."""
        _, _, strongest = self.core.update_connections(kf, COVIS_TH)
        if strongest >= 0 and kf not in self.parent and kf != 0:
            self.parent[kf] = strongest
            self.children.setdefault(strongest, set()).add(kf)

    def covisible_neighbors(self, kf: int, n: Optional[int] = None) -> List[int]:
        """Neighbors ordered by weight DESC (intended semantics; the
        reference's incremental update sorts ascending by mistake)."""
        ids, _ = self.core.neighbors(kf, cap=(n if n is not None else 4096))
        return ids.tolist()

    def covis_weight(self, a: int, b: int) -> int:
        return self.core.covis_weight(a, b)

    # ------------- observation management -------------

    def erase_observation(self, lm: int, kf: int):
        self.core.erase_observation(lm, kf)

    def kill_landmark(self, lm: int):
        self.core.kill_landmark(lm)

    def replace_landmark(self, lm: int, by: int):
        """MapPoint.replace (MapPoint.py:157-182): forward all observations."""
        self.core.replace_landmark(lm, by)

    # ------------- maintenance -------------

    def cull_map_points(self, recent_ids: np.ndarray, current_kf: int,
                        created_kf: np.ndarray):
        """LocalMapping.map_point_culling: kill points with found/visible
        < 0.25, or with <= 3 stereo-equivalent observations 2-3 KFs after
        creation."""
        lm = self.landmarks
        recent_ids = np.asarray(recent_ids, np.int64)
        if len(recent_ids) == 0:
            return
        alive = lm.alive[recent_ids]
        ratio = lm.found[recent_ids] / np.maximum(lm.visible[recent_ids], 1)
        age = current_kf - created_kf[recent_ids]
        kill = alive & ((ratio < 0.25) | ((age >= 2) & (lm.n_obs[recent_ids] <= 3)))
        for p in recent_ids[kill]:
            self.core.kill_landmark(int(p))

    def update_landmark_geometry(self, lm_ids: np.ndarray):
        """MapPoint.update_normal_and_depth for a batch of landmarks,
        vectorized over a native CSR observer dump."""
        lm = self.landmarks
        lm_ids = np.asarray(lm_ids, np.int32)
        lm_ids = lm_ids[lm.alive[lm_ids]]
        if len(lm_ids) == 0:
            return
        off, pair_k, pair_f = self.core.observers_csr(lm_ids)
        counts = np.diff(off)
        has = counts > 0
        ids = lm_ids[has]
        if len(ids) == 0:
            return
        pair_l = np.repeat(np.arange(len(lm_ids), dtype=np.int32), counts)
        sel = has[pair_l]
        # re-index pair_l into the filtered id list
        remap = np.cumsum(has) - 1
        pair_l = remap[pair_l[sel]].astype(np.int32)
        pair_k = pair_k[sel]
        pos = lm.pos[ids]

        Tcw = self.keyframes.Tcw[pair_k]
        Ow = -np.einsum("mji,mj->mi", Tcw[:, :3, :3], Tcw[:, :3, 3])
        d = pos[pair_l] - Ow
        n = np.linalg.norm(d, axis=1)
        ok = n > 1e-6
        dn = np.where(ok[:, None], d / np.maximum(n, 1e-12)[:, None], 0.0)
        sums = np.zeros((len(ids), 3), np.float64)
        np.add.at(sums, pair_l, dn)
        nn = np.linalg.norm(sums, axis=1)   # mean dir ∝ sum dir
        upd = nn > 1e-6
        lm.normal[ids[upd]] = (sums[upd] / nn[upd, None]).astype(np.float32)

        # depth band from the reference (first) observation
        ref_kf = pair_k[off[:len(lm_ids)][has]]
        ref_feat = pair_f[off[:len(lm_ids)][has]]
        Tr = self.keyframes.Tcw[ref_kf]
        Owr = -np.einsum("mji,mj->mi", Tr[:, :3, :3], Tr[:, :3, 3])
        dist = np.linalg.norm(pos - Owr, axis=1)
        level = self.keyframes.kp_octave[ref_kf, ref_feat]
        sf = self.cfg.orb.scale_factor
        max_dist = dist * sf ** level
        min_dist = max_dist / (sf ** (self.cfg.orb.n_levels - 1))
        lm.dmax[ids] = 1.2 * max_dist
        lm.dmin[ids] = 0.8 * min_dist
        lm.mark_dirty(ids)

    # ------------- global bundle adjustment -------------

    def global_ba(self, iters: Optional[int] = None) -> dict:
        """Optimizer.bundle_adjustment (Optimizer.py:21-121): all live
        keyframes and observed landmarks, KF 0 fixed, ``gba_iters`` (10)
        LM iterations of one robust phase, run after a loop closure.
        ``iters`` overrides the count for the bounded slices the loop
        closer spreads over the following keyframes (the reference's
        abortable GBA thread, LoopClosing.py:342-436)."""
        C_live = [k for k in range(self.keyframes.n) if self.keyframes.alive[k]]
        pnt_ids = self.core.observed_landmarks(self.landmarks.n)
        if len(C_live) < 2 or len(pnt_ids) < 50:
            return dict(ran=False)
        # the JAX package takes its multi-device engine where it sees more
        # than one device (len(jax.devices()) > 1); a CPU is one device
        if len(C_live) <= GBA_DENSE_MAX_KFS:
            engine = "dense"
        elif self.device.type == "cuda" and torch.cuda.device_count() > 1:
            engine = "dist"
        else:
            engine = "cg"
        return self._run_ba(
            cams=C_live, n_free=len(C_live), pnt_ids=pnt_ids,
            iters1=(self.cfg.ba.gba_iters if iters is None else iters),
            iters2=0, erase_outliers=False, engine=engine,
        )

    # ------------- local bundle adjustment -------------

    def observation_chi2(self, ki: np.ndarray, fi: np.ndarray,
                         ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Stereo-reprojection chi2 of the observations (keyframe ``ki``,
        feature ``fi``) of landmarks ``ids`` under the map's geometry, and
        each one's depth in its camera."""
        ks, lm = self.keyframes, self.landmarks
        P = lm.pos[ids]
        T = ks.Tcw[ki]
        Pc = np.einsum("mij,mj->mi", T[:, :3, :3], P) + T[:, :3, 3]
        z = np.maximum(Pc[:, 2], 1e-6)
        c = self.cfg.camera
        u = c.fx * Pc[:, 0] / z + c.cx
        v = c.fy * Pc[:, 1] / z + c.cy
        du = u - ks.kp_xy[ki, fi, 0]
        dv = v - ks.kp_xy[ki, fi, 1]
        ur_obs = ks.u_right[ki, fi]
        dur = np.where(ur_obs > 0, (u - c.bf / z) - ur_obs, 0.0)
        inv_s2 = np.asarray(self.cfg.orb.inv_level_sigma2)[
            ks.kp_octave[ki, fi]]
        return (du * du + dv * dv + dur * dur) * inv_s2, Pc[:, 2]

    def reprojection_chi2(self, huber_delta: float = 2.7955) -> float:
        """Mean Huberized stereo-reprojection chi2 over every live
        observation: the map's own quality metric, used by the loop
        corrector's accept/rollback A/B (a correction that raises this
        on identical topology made the map worse).  delta^2 = 7.815,
        the reference's stereo chi2 gate."""
        ks, lm = self.keyframes, self.landmarks
        n_kf = ks.n
        if n_kf == 0:
            return 0.0
        obs = ks.obs_lm[:n_kf]
        kf_alive = ks.alive[:n_kf, None]
        mask = (obs >= 0) & kf_alive
        safe = np.maximum(obs, 0)
        mask &= lm.alive[safe]
        ki, fi = np.nonzero(mask)
        if len(ki) == 0:
            return 0.0
        chi2, depth = self.observation_chi2(ki, fi, obs[ki, fi])
        # Huber: quadratic below delta^2, linear above: one gross
        # outlier must not dominate the map-level mean
        d2 = huber_delta * huber_delta
        e = np.sqrt(np.maximum(chi2, 1e-12))
        rho = np.where(chi2 <= d2, chi2, 2.0 * huber_delta * e - d2)
        # behind-camera observations are maximally wrong
        rho = np.where(depth <= 0, 2.0 * huber_delta * 50.0, rho)
        return float(rho.mean())

    def erase_disagreeing(self, ki: np.ndarray, fi: np.ndarray,
                          ids: np.ndarray) -> int:
        """Erase the observations (keyframe ``ki``, feature ``fi``) of
        landmarks ``ids`` that the map's geometry rejects by local BA's
        own inlier rule (chi2 above the stereo gate, or behind the
        camera); returns how many went."""
        if len(ki) == 0:
            return 0
        chi2, depth = self.observation_chi2(ki, fi, ids)
        bad = np.nonzero((chi2 > ba.CHI2_STEREO) | (depth <= 0))[0]
        for o in bad:
            self.core.erase_observation(int(ids[o]), int(ki[o]))
        return len(bad)

    def local_ba(self, kf: int, split: bool = False) -> dict:
        """Assemble + run the Schur BA over the covisible neighborhood of
        ``kf``; write back poses/points and erase outlier observations.
        With ``split=True`` the solve is only DISPATCHED: the result dict
        carries ``pending`` for a later :meth:`local_ba_apply`: the
        pipelined schedule reads the solution one frame later, under the
        device's next tracking step."""
        bacfg = self.cfg.ba
        cams, n_free, pnt_ids = self.core.local_ba_gather(
            kf, bacfg.max_local_kfs, bacfg.max_local_points,
            2 * bacfg.max_local_kfs)
        return self._run_ba(
            cams=cams, n_free=n_free, pnt_ids=pnt_ids,
            iters1=bacfg.local_ba_iters1, iters2=bacfg.local_ba_iters2,
            erase_outliers=True, split=split,
            max_move=bacfg.local_ba_max_move_m,
        )

    def _run_ba(self, cams, n_free: int, pnt_ids,
                iters1: int, iters2: int, erase_outliers: bool,
                engine: str = "dense", split: bool = False,
                max_move: Optional[float] = None, mesh=None) -> dict:
        """Assemble bucketed fixed-shape arrays (native observation
        gather), dispatch the Schur BA (the dense grid engine, or
        implicit-Schur CG at global scale, on one device or sharded over
        ``mesh``: ``parallel/dist_ba.make_mesh()`` where none is given),
        write back, optionally erase outlier observations.  The buckets
        keep the device program few-shaped (padding rows are inert): on a
        card the dense solve replays a CUDA graph per bucket and iteration
        counts (``DENSE_BA``; the ``ba.solve`` span's ``graph`` says
        whether it did).  Every host array goes to the device through
        pinned memory, so a dispatch never waits for the work queued
        before it."""
        if engine not in ("dense", "cg", "dist"):
            raise ValueError(f"unknown BA engine {engine!r}")
        # dist is the CG engine sharded, with the same full-scale buckets
        cg = engine in ("cg", "dist")
        cams = np.asarray(cams, np.int32)
        pnt_ids = np.asarray(pnt_ids, np.int32)
        C = _bucket(len(cams), CG_CAM_BUCKETS if cg else CAM_BUCKETS)
        P = _bucket(len(pnt_ids), CG_PNT_BUCKETS if cg else PNT_BUCKETS)
        obs_buckets = CG_OBS_BUCKETS if cg else OBS_BUCKETS
        # beyond the largest bucket the problem is cut, as in the JAX
        # package (its slam_map.py:369); the cuts are counted
        for what, n, cap in (("cams", len(cams), C), ("points", len(pnt_ids), P)):
            if n > cap:
                self.counters[f"ba.truncated_{what}"] += n - cap
        cams = cams[:C]
        n_free = min(n_free, C)
        pnt_ids = pnt_ids[:P]

        ks = self.keyframes
        with trace.stage(self.times, "ba.assemble") as sp:
            oc, op, okf, oft = self.core.assemble_obs(
                cams, pnt_ids, cap=obs_buckets[-1])
            if sp is not None:
                sp.args.update(cameras=len(cams), points=len(pnt_ids),
                               observations=len(oc))
        n_obs = len(oc)
        if n_obs == obs_buckets[-1]:
            # the gather stopped at its capacity: later observations are cut
            self.counters["ba.obs_at_capacity"] += 1
        if n_obs < 20 or len(pnt_ids) < 10:
            return dict(ran=False)
        O = _bucket(n_obs, obs_buckets)
        n_obs = min(n_obs, O)
        oc, op, okf, oft = oc[:n_obs], op[:n_obs], okf[:n_obs], oft[:n_obs]
        inv_sigma2 = np.asarray(self.cfg.orb.inv_level_sigma2, np.float32)

        cam_Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_Tcw[: len(cams)] = ks.Tcw[cams]
        cam_fixed = np.ones(C, bool)
        for i, k in enumerate(cams):
            cam_fixed[i] = (i >= n_free) or (k == 0)

        # sort by point id (the BA grid layout groups observations per
        # point); within a point, FREE cameras first: when a
        # heavily-observed point exceeds the grid width K, the slots
        # dropped are fixed-camera ones, which only constrain the
        # (already over-determined) point, not the poses being solved
        order = np.lexsort((cam_fixed[oc], op))
        oc, op, okf, oft = oc[order], op[order], okf[order], oft[order]
        pnt_pos = np.zeros((P, 3), np.float32)
        pnt_pos[: len(pnt_ids)] = self.landmarks.pos[pnt_ids]
        pnt_active = np.zeros(P, bool)
        pnt_active[: len(pnt_ids)] = True

        ouvr = np.stack([ks.kp_xy[okf, oft, 0], ks.kp_xy[okf, oft, 1],
                         ks.u_right[okf, oft]], axis=1).astype(np.float32)
        c = self.cfg.camera
        dev = self.device
        cam5_host = np.asarray([c.fx, c.fy, c.cx, c.cy, c.bf], np.float32)
        cam5 = device_constant(cam5_host, torch.float32, dev)

        def up(a):
            return upload(np.ascontiguousarray(a), dev)

        if engine == "dist":
            return self._run_ba_dist(
                cams, cam_fixed, n_free, pnt_ids, cam_Tcw, oc, op, okf, oft,
                ouvr, inv_sigma2, cam5, n_obs, iters1, iters2,
                erase_outliers, max_move, mesh)
        if cg:
            return self._run_ba_cg(
                cams, cam_fixed, n_free, pnt_ids, cam_Tcw, pnt_pos,
                pnt_active, oc, op, okf, oft, ouvr, inv_sigma2, cam5, O,
                n_obs, iters1, iters2, erase_outliers, max_move, up)

        # dense engine: the (P, K) observation grid, scatter-free Schur
        # assembly (optim/ba.py:BAGridProblem).  K is chosen adaptively
        # from {8, 16, 32}: the smallest width that drops no FREE-camera
        # observation (grid rows are free-cams-first, so slots beyond K
        # shed fixed-anchor redundancy first).  K=8 covers the common
        # case (mean track length 2-3).
        counts = np.bincount(op, minlength=P)
        K = 8
        if counts.max(initial=0) > 8:
            free_counts = np.bincount(op[~cam_fixed[oc]], minlength=P)
            mfree = int(free_counts.max(initial=0))
            for k_try in (16, 32):
                if mfree > K:
                    K = k_try
            dropped_free = int(np.clip(free_counts - K, 0, None).sum())
            if dropped_free:
                self.counters["ba.grid_dropped_free_obs"] += dropped_free
        # packed upload (grid_pack_from_obs): i16 cam ids, 1/16-px i16
        # fixed-point (u, v, u_r), u8 octaves with the inv-sigma2 lookup
        # on the device
        g_cam, g_uvrq, g_oct, g_act, slot, kept, n_drop = \
            ba.grid_pack_from_obs(oc, op, ouvr, ks.kp_octave[okf, oft], P, K=K)
        if n_drop:
            self.counters["ba.grid_dropped_obs"] += n_drop

        with trace.stage(self.times, "ba.solve") as sp:
            packed, graph = DENSE_BA(
                functools.partial(
                    _dense_ba_body, cam=cam5,
                    isig_table=device_constant(inv_sigma2, torch.float32, dev),
                    iters1=iters1, iters2=iters2),
                (cam_Tcw, cam_fixed, pnt_pos, pnt_active,
                 g_cam, g_uvrq, g_oct, g_act),
                dev, settings=(iters1, iters2, cam5_host.tobytes(),
                               inv_sigma2.tobytes()),
                counters=dict(cameras=C, points=P, width=K, iters1=iters1,
                              iters2=iters2))
            if sp is not None:
                sp.args["graph"] = int(graph)
            # the copy to the host starts here; a split caller reads it a
            # frame later without a stall
            handle = HostRead(packed)
            if not split and dev.type == "cuda":
                # the synchronous schedule reads the result next; the wait
                # belongs to the solve, not to the read
                torch.cuda.synchronize(dev)
        pend = dict(
            handle=handle, C=C, P=P, O=O, g_shape=g_act.shape,
            op=op, okf=okf, slot=slot, kept=kept,
            cams=cams, cam_fixed=cam_fixed, n_free=n_free,
            pnt_ids=pnt_ids, n_obs=n_obs,
            erase_outliers=erase_outliers, max_move=max_move,
        )
        if split:
            return dict(ran=True, pending=pend, n_cams=len(cams),
                        n_free=n_free, n_points=len(pnt_ids),
                        n_obs=n_obs)
        return self.local_ba_apply(pend)

    def _run_ba_cg(self, cams, cam_fixed, n_free, pnt_ids, cam_Tcw, pnt_pos,
                   pnt_active, oc, op, okf, oft, ouvr, inv_sigma2, cam5, O,
                   n_obs, iters1, iters2, erase_outliers, max_move, up):
        """The CG rung of :meth:`_run_ba`: flat observations padded to the
        bucket ``O`` (padding rows carry the last point id and are
        inactive), one solve, ONE packed read, write back."""
        C, P = cam_Tcw.shape[0], pnt_pos.shape[0]
        ocp = np.zeros(O, np.int32)
        opp = np.full(O, P - 1, np.int32)
        ouvrp = np.zeros((O, 3), np.float32)
        oisig = np.zeros(O, np.float32)
        oact = np.zeros(O, bool)
        ocp[:n_obs] = oc
        opp[:n_obs] = op
        ouvrp[:n_obs] = ouvr
        oisig[:n_obs] = inv_sigma2[self.keyframes.kp_octave[okf, oft]]
        oact[:n_obs] = True
        prob = ba.BAProblem(
            cam_Tcw=up(cam_Tcw), cam_fixed=up(cam_fixed),
            pnt_pos=up(pnt_pos), pnt_active=up(pnt_active),
            obs_cam=up(ocp), obs_pnt=up(opp), obs_uvr=up(ouvrp),
            obs_inv_sigma2=up(oisig), obs_active=up(oact), cam=cam5)
        with trace.stage(self.times, "ba.solve"):
            res = ba_cg.bundle_adjust_cg(prob, iters1=iters1, iters2=iters2)
            out = HostRead(_pack_ba_result(res.cam_Tcw, res.pnt_pos,
                                           res.obs_inlier)).numpy()
        new_Tcw = out[: 16 * C].view(np.float32).reshape(C, 4, 4)
        new_pos = out[16 * C: 16 * C + 3 * P].view(np.float32).reshape(P, 3)
        inlier = np.unpackbits(out[16 * C + 3 * P:].view(np.uint8),
                               bitorder="little")[:O].astype(bool)
        return self._ba_writeback(
            cams, cam_fixed, n_free, pnt_ids, new_Tcw, new_pos, inlier,
            op, okf, n_obs, erase_outliers, max_move=max_move)

    def _run_ba_dist(self, cams, cam_fixed, n_free, pnt_ids, cam_Tcw, oc, op,
                     okf, oft, ouvr, inv_sigma2, cam5, n_obs, iters1, iters2,
                     erase_outliers, max_move, mesh):
        """The ``dist`` rung of :meth:`_run_ba` (the JAX package's
        ``slam_map.py:418-453``): P padded to a multiple of the shard
        count, observations regrouped so each lands on its point's owner
        shard, the sharded CG engine, one read, write back.  The
        write-back erases nothing: the engine's inlier mask is in the
        regrouped order."""
        from pyorbslam_tpu_torch.parallel import dist_ba

        if mesh is None:
            if self.device.type != "cuda":
                raise ValueError("the dist BA engine shards over CUDA devices; "
                                 f"the map is on {self.device}: pass a mesh")
            mesh = dist_ba.make_mesh()
        n = mesh.n_shards
        C = cam_Tcw.shape[0]
        P = -(-_bucket(len(pnt_ids), CG_PNT_BUCKETS) // n) * n
        pnt_pos = np.zeros((P, 3), np.float32)
        pnt_pos[: len(pnt_ids)] = self.landmarks.pos[pnt_ids]
        pnt_active = np.zeros(P, bool)
        pnt_active[: len(pnt_ids)] = True
        isig = inv_sigma2[self.keyframes.kp_octave[okf, oft]]
        g_op, (g_oc, g_uvr, g_isig), g_act = \
            dist_ba.group_observations_by_point_shard(
                op.astype(np.int32), P, n,
                (oc.astype(np.int32), ouvr, isig.astype(np.float32)))
        t = torch.from_numpy
        prob = ba.BAProblem(
            cam_Tcw=t(cam_Tcw), cam_fixed=t(cam_fixed), pnt_pos=t(pnt_pos),
            pnt_active=t(pnt_active), obs_cam=t(g_oc), obs_pnt=t(g_op),
            obs_uvr=t(g_uvr), obs_inv_sigma2=t(g_isig), obs_active=t(g_act),
            cam=cam5)
        with trace.stage(self.times, "ba.solve"):
            d_cam, d_pnt, _ = dist_ba.distributed_bundle_adjust_cg(
                dist_ba.shard_problem(prob, mesh), mesh, n_cam=C,
                iters1=iters1, iters2=iters2)
            out = torch.cat([d_cam.reshape(-1), d_pnt.reshape(-1)]).cpu().numpy()
        new_Tcw = out[: 16 * C].reshape(C, 4, 4)
        new_pos = out[16 * C:].reshape(P, 3)
        return self._ba_writeback(
            cams, cam_fixed, n_free, pnt_ids, new_Tcw, new_pos, None,
            op, okf, n_obs, erase_outliers, max_move=max_move)

    def local_ba_apply(self, pend: dict) -> dict:
        """Consume a split dense-BA dispatch: ONE host read, write back
        poses/points, erase outliers, refresh landmark geometry."""
        C, P, O = pend["C"], pend["P"], pend["O"]
        with trace.stage(self.times, "ba.read"):
            out = pend["handle"].numpy()
        new_Tcw = out[: 16 * C].view(np.float32).reshape(C, 4, 4)
        new_pos = out[16 * C: 16 * C + 3 * P].view(np.float32).reshape(P, 3)
        g_size = int(np.prod(pend["g_shape"]))
        g_inl = np.unpackbits(
            out[16 * C + 3 * P:].view(np.uint8),
            bitorder="little")[:g_size].astype(bool).reshape(pend["g_shape"])
        op, slot, kept = pend["op"], pend["slot"], pend["kept"]
        inlier = np.ones(O, bool)
        inlier[: pend["n_obs"]][kept] = g_inl[op[kept], slot[kept]]
        return self._ba_writeback(
            pend["cams"], pend["cam_fixed"], pend["n_free"],
            pend["pnt_ids"], new_Tcw, new_pos, inlier,
            op, pend["okf"], pend["n_obs"], pend["erase_outliers"],
            max_move=pend.get("max_move"))

    def _ba_writeback(self, cams, cam_fixed, n_free, pnt_ids,
                      new_Tcw, new_pos, inlier, op, okf, n_obs,
                      erase_outliers, max_move=None) -> dict:
        ks = self.keyframes
        if max_move is not None:
            # local-BA sanity guard: a nominal refinement never moves a
            # camera meters.  A solve that "prefers" a distant optimum is
            # feeding on corrupted geometry (e.g. coherently mis-matched
            # landmarks): dropping the write-back keeps the healthy
            # odometry poses and lets observation gating clean up
            # instead.  Reference parity note: g2o local BA has no such
            # guard, but it also runs f64 with strictly-local windows;
            # large legitimate corrections arrive via the pose graph /
            # GBA (uncapped).
            moves = []
            for i in range(n_free):
                if cam_fixed[i]:
                    continue
                Tn, To = new_Tcw[i], ks.Tcw[cams[i]]
                Cn = -Tn[:3, :3].T @ Tn[:3, 3]
                Co = -To[:3, :3].T @ To[:3, 3]
                moves.append(float(np.linalg.norm(Cn - Co)))
            if moves and max(moves) > max_move:
                self.counters["ba.rejected_writebacks"] += 1
                return dict(ran=True, rejected=True, n_cams=len(cams),
                            n_free=n_free, n_points=len(pnt_ids),
                            n_obs=n_obs, n_erased=0,
                            max_move=max(moves))
        for i in range(n_free):
            if not cam_fixed[i]:
                ks.Tcw[cams[i]] = new_Tcw[i]
        self.landmarks.pos[pnt_ids] = new_pos[: len(pnt_ids)]
        self.landmarks.mark_dirty(pnt_ids)

        n_erased = 0
        if erase_outliers and inlier is not None:
            alive = self.landmarks.alive
            for o in np.nonzero(~inlier[:n_obs])[0]:
                lm = int(pnt_ids[op[o]])
                # apply-time guard (pipelined schedule): an interleaved
                # fuse may have replaced/killed this landmark since the
                # BA dispatch: the reference's equivalent erase on a
                # replaced MapPoint is a no-op, so skip
                if not alive[lm]:
                    continue
                self.core.erase_observation(lm, int(okf[o]))
                n_erased += 1

        with trace.stage(self.times, "ba.geometry"):
            self.update_landmark_geometry(pnt_ids)
        return dict(
            ran=True, n_cams=len(cams), n_free=n_free,
            n_points=len(pnt_ids), n_obs=n_obs, n_erased=n_erased,
        )
