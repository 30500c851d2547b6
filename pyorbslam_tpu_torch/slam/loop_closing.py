"""Loop closing: detection, Sim3 computation, loop correction.

Port of ``pyorbslam_tpu/slam/loop_closing.py``.  Replaces LoopClosing.py
as a synchronous stage invoked per keyframe:

  * :meth:`LoopCloser.detect`: BoW candidates below the covisible-score
    floor, filtered by 3-consecutive consistency groups
    (LoopClosing.py:80-144);
  * :meth:`LoopCloser.compute_sim3`: per candidate, BoW matching >= 20,
    parallel Horn Sim3 RANSAC (scale fixed for stereo), relative Sim3
    refinement >= 20 inliers, then projection of the loop-region point
    cloud with the corrected pose requiring >= 40 total matches
    (LoopClosing.py:146-247);
  * :meth:`LoopCloser.correct`: propagate the corrected Sim3 to the
    current keyframe's covisible group, remap their landmarks, fuse loop
    duplicates, optimize the essential graph with the loop keyframe
    fixed, keep or roll back the new geometry by the map's reprojection
    chi2, add loop edges, and start the global BA
    (LoopClosing.py:249-436, synchronous instead of threaded).

Each device stage ends in ONE packed read, as in the JAX package; the
stage reads its result because the next decision (go on with this
candidate or not) is the host's.  The RANSAC minimal sets are drawn from
a ``torch.Generator`` seeded with the keyframe id, where the JAX package
seeds ``jax.random.PRNGKey(kf)``: the two draw other sets
(``optim/horn.py``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Dict, List, Set, Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.config import SlamConfig
from pyorbslam_tpu_torch.ops import matching as match_ops
from pyorbslam_tpu_torch.ops.hamming import popcount, unpack_bits
from pyorbslam_tpu_torch.optim.horn import sim3_ransac
from pyorbslam_tpu_torch.optim.pose_graph import (
    optimize_pose_graph,
    optimize_pose_graph_cg,
)
from pyorbslam_tpu_torch.optim.sim3_opt import optimize_sim3
from pyorbslam_tpu_torch.place.keyframe_db import KeyFrameDatabase
from pyorbslam_tpu_torch.place.vocabulary import Vocabulary
from pyorbslam_tpu_torch.slam.local_mapping import (
    fuse_match_batch,
    fuse_match_step,
)
from pyorbslam_tpu_torch.slam.slam_map import SlamMap
from pyorbslam_tpu_torch.slam.tracking import _consts
from pyorbslam_tpu_torch.utils import trace
from pyorbslam_tpu_torch.utils.host_read import upload


def _sim3_from_T(T: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    return T[:3, :3].copy(), T[:3, 3].copy(), 1.0


def _sim3_mul(a, b):
    """(R, t, s) composition a*b."""
    Ra, ta, sa = a
    Rb, tb, sb = b
    return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb


def _sim3_inv(a):
    R, t, s = a
    return R.T, -(R.T @ t) / s, 1.0 / s


def _sim3_map(a, P):
    R, t, s = a
    return s * (P @ R.T) + t


def _pack_f32(*parts: torch.Tensor) -> np.ndarray:
    """Several small device results as ONE float32 read."""
    return torch.cat([p.reshape(-1).to(torch.float32) for p in parts]).cpu().numpy()


def _region_points(m: SlamMap, kf: int) -> Set[int]:
    """Live landmarks of ``kf`` and its 10 best covisibles."""
    ks, lm = m.keyframes, m.landmarks
    pts: Set[int] = set()
    for k2 in [kf] + m.covisible_neighbors(kf, 10):
        ids = lm.resolve(ks.obs_lm[k2])
        pts.update(int(i) for i in ids[ids >= 0] if lm.alive[i])
    return pts


def _point_slots(cfg: SlamConfig, pts) -> np.ndarray:
    """Landmark ids padded with -1 to a power-of-two capacity from 1024."""
    loop_ids = np.fromiter(pts, np.int32)
    cap = 1024
    while cap < len(loop_ids) and cap < cfg.tracking.max_local_points:
        cap *= 2
    p_ids = np.full(cap, -1, np.int32)
    p_ids[: min(len(loop_ids), cap)] = loop_ids[:cap]
    return p_ids


@dataclasses.dataclass
class LoopCloser:
    cfg: SlamConfig
    map: SlamMap
    voc: Vocabulary
    kfdb: KeyFrameDatabase
    consistency_th: int = 3

    def __post_init__(self):
        self.prev_groups: List[Tuple[Set[int], int]] = []  # (group, count)
        self.last_loop_kf: int = -10 ** 9
        self.n_loops_closed: int = 0
        self.n_loops_rejected: int = 0
        self.n_loops_fused: int = 0   # rejected geometry, kept topology
        # Sim3-ladder diagnostics; bounded so long runs do not grow host
        # memory without limit
        self.events: deque = deque(maxlen=4096)
        self.times = defaultdict(float)   # per-stage wall clock
        # Sim3-failure cooldown: candidate covisibility groups that just
        # failed geometric verification are skipped for a few keyframes.
        # On visually aliased worlds the same region re-enters the
        # consistency window every keyframe, and each doomed attempt costs
        # the whole RANSAC + refine ladder.  A genuine loop is delayed at
        # most SIM3_FAIL_COOLDOWN keyframes.
        self._sim3_fail: deque = deque(maxlen=32)   # (group: Set[int], kf)
        self._gba_remaining = 0

    SIM3_FAIL_COOLDOWN = 3   # keyframes

    @property
    def device(self) -> torch.device:
        return self.map.device

    def _pose_graph_mesh(self, big: bool):
        """The mesh the essential graph is sharded over
        (``parallel/dist_pose_graph.py``): above the CG threshold, every
        CUDA device where several are visible, as the JAX package shards
        where it sees several devices; else None (one device)."""
        if big and self.device.type == "cuda" and torch.cuda.device_count() > 1:
            from pyorbslam_tpu_torch.parallel import dist_ba

            return dist_ba.make_mesh()
        return None

    def _up(self, a) -> torch.Tensor:
        # np.asarray keeps a 0-dim array 0-dim (ascontiguousarray does not)
        return upload(np.asarray(a, order="C"), self.device)

    # ------------------------------ detection ------------------------------

    def detect(self, kf: int, bow: Dict[int, float]) -> List[int]:
        if kf < self.last_loop_kf + 10 or self.map.keyframes.n < 10:
            self.prev_groups = []
            return []
        neighbors = self.map.covisible_neighbors(kf)
        if not neighbors:
            return []
        min_score = min(
            Vocabulary.score(bow, self.kfdb.bow.get(n, {})) for n in neighbors
        )
        cands = self.kfdb.detect_loop_candidates(
            kf, bow, min_score, set(neighbors), self.map.covisible_neighbors
        )
        if not cands:
            self.prev_groups = []
            return []

        # consistency groups over consecutive detections
        consistent: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for cand in cands:
            group = set(self.map.covisible_neighbors(cand)) | {cand}
            count = 0
            for prev, prev_count in self.prev_groups:
                if group & prev:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= self.consistency_th:
                consistent.append(cand)
        self.prev_groups = new_groups
        return consistent

    # ------------------------------ Sim3 ------------------------------

    # Sim3 verification budget per keyframe: each candidate costs several
    # device round trips (BoW match + Horn RANSAC + guided rescue); the
    # reference's consistency window rarely yields more than 2-3
    # candidates on a genuine revisit.
    MAX_SIM3_CANDIDATES = 3

    @staticmethod
    def _match_bow_batch(cur_desc, cur_node, cur_ok,
                         cand_desc, cand_node, cand_ok) -> np.ndarray:
        """All candidates' exhaustive BoW matching (no node gate, ratio
        0.75) as one device program and ONE read: (B, 2, N) int32 rows of
        (match index, matched)."""
        cur_bits, cur_pop = unpack_bits(cur_desc), popcount(cur_desc)
        rows = []
        for cd, cn, co in zip(cand_desc, cand_node, cand_ok):
            idx, _, matched = match_ops.match_by_bow(
                cur_bits, cur_pop, cur_node, cur_ok,
                unpack_bits(cd), popcount(cd), cn, co,
                ratio=0.75, node_gate=False)
            rows.append(torch.stack([idx, matched.to(torch.int32)]))
        return torch.stack(rows).cpu().numpy()

    def _cooldown_filter(self, kf: int, candidates: List[int]) -> List[int]:
        """Drop candidates whose covisibility group failed geometric
        verification within the last SIM3_FAIL_COOLDOWN keyframes."""
        if not self._sim3_fail:
            return candidates
        kept = []
        for cand in candidates:
            group = set(self.map.covisible_neighbors(cand)) | {cand}
            if any(kf - k0 <= self.SIM3_FAIL_COOLDOWN and (group & g)
                   for g, k0 in self._sim3_fail):
                self.events.append((kf, cand, "cooldown", 0))
            else:
                kept.append(cand)
        return kept

    def _ransac(self, kf: int, *arrays):
        """The Horn Sim3 RANSAC on host arrays padded to the bucket, with
        minimal sets drawn from a generator seeded with ``kf``."""
        generator = torch.Generator(device=self.device)
        generator.manual_seed(int(kf))
        *data, active = (self._up(a) for a in arrays)
        return sim3_ransac(*data, active, _consts(self.cfg, self.device).cam[:4],
                           generator, with_scale=False)

    def compute_sim3(self, kf: int, candidates: List[int]):
        """Returns (loop_kf, Scw=(R,t,s), matched landmark map feat->lm) or None."""
        candidates = self._cooldown_filter(kf, candidates)
        if not candidates:
            return None
        candidates = candidates[: self.MAX_SIM3_CANDIDATES]
        attempted: List[int] = []   # candidates that reached geometry
        ks = self.map.keyframes
        lm = self.map.landmarks
        dev = self.device
        cam4 = _consts(self.cfg, dev).cam[:4]
        sigma2 = np.asarray(self.cfg.orb.level_sigma2)

        cur_lm = lm.resolve(ks.obs_lm[kf])
        # search_by_BoW_kf_kf (ORBMatcher.py:120-213): match features that
        # carry LIVE landmarks on both sides; the Sim3 geometry uses the
        # landmark positions mapped into each camera (Sim3Solver.py:27-56).
        # All candidates match in one program and one read.
        cur_ok = ks.kp_valid[kf] & (cur_lm >= 0) \
            & lm.alive[np.maximum(cur_lm, 0)]
        CANDS = self.MAX_SIM3_CANDIDATES
        sel = np.asarray((candidates + [candidates[0]] * CANDS)[:CANDS])
        cand_lms = [lm.resolve(ks.obs_lm[c]) for c in sel]
        cand_ok = np.stack([
            ks.kp_valid[c] & (clm >= 0) & lm.alive[np.maximum(clm, 0)]
            for c, clm in zip(sel, cand_lms)])
        with trace.stage(self.times, "loop.sim3_bow"):
            bow_rows = self._match_bow_batch(
                self._up(ks.kp_desc[kf]), self._up(ks.kp_node[kf]),
                self._up(cur_ok), self._up(ks.kp_desc[sel]),
                self._up(ks.kp_node[sel]), self._up(cand_ok))

        for ci, cand in enumerate(candidates):
            cand_lm = cand_lms[ci]
            idx, matched = bow_rows[ci, 0], bow_rows[ci, 1].astype(bool)
            qi = np.nonzero(matched)[0]
            fi = idx[qi]
            self.events.append((kf, cand, "bow_pairs", len(qi)))
            if len(qi) < 20:
                continue
            attempted.append(cand)
            # RANSAC shapes come from a 2-size ladder (128 / 512); past
            # 512 pairs the minimal-set solver gains nothing from more,
            # so subsample deterministically
            if len(qi) > 512:
                rs = np.random.default_rng(kf * 1315423911 + cand)
                keep = np.sort(rs.choice(len(qi), 512, replace=False))
                qi, fi = qi[keep], fi[keep]

            T1, T2 = ks.Tcw[kf], ks.Tcw[cand]
            L1 = cur_lm[qi]
            L2 = cand_lm[fi]
            X1c = (lm.pos[L1] @ T1[:3, :3].T + T1[:3, 3]).astype(np.float32)
            X2c = (lm.pos[L2] @ T2[:3, :3].T + T2[:3, 3]).astype(np.float32)
            uv1 = ks.kp_xy[kf, qi]
            uv2 = ks.kp_xy[cand, fi]
            s2_1 = sigma2[ks.kp_octave[kf, qi]].astype(np.float32)
            s2_2 = sigma2[ks.kp_octave[cand, fi]].astype(np.float32)
            n = len(qi)

            B = 128 if n <= 128 else 512
            pad = B - n

            def _p(a, fill=0.0):
                return np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) \
                    if pad else a

            with trace.stage(self.times, "loop.sim3_ransac"):
                res = self._ransac(
                    kf, _p(X1c), _p(X2c), _p(uv1), _p(uv2), _p(s2_1, 1.0),
                    _p(s2_2, 1.0), np.arange(B) < n)
                # one read: R (9) | t (3) | s (1) | inliers (B)
                out = _pack_f32(res.R, res.t, res.s, res.inliers)
                R_r, t_r, s_r = out[:9].reshape(3, 3), out[9:12], float(out[12])
                inl_all = out[13:].astype(bool)
                n_in = int(inl_all.sum())
                res_ok = n_in >= 20
            self.events.append((kf, cand, "ransac", n_in if res_ok else -1))
            if not res_ok:
                continue

            # grow correspondences by MUTUAL Sim3 projection between the
            # two keyframes (ORBMatcher.search_by_sim3, th=7.5) seeded
            # with the RANSAC estimate, then refine the Sim3 over the
            # combined set (LoopClosing.py:203-210)
            inl = inl_all[:n]
            seed_q = qi[inl]
            seed_f = fi[inl]
            with trace.stage(self.times, "loop.sim3_grow"):
                grown12 = self._search_by_sim3(kf, cand, R_r, t_r, s_r,
                                               seed_q, seed_f)

            N = ks.obs_lm.shape[1]
            pair_f = np.full(N, -1, np.int32)
            active = np.zeros(N, bool)
            X1 = np.zeros((N, 3), np.float32)
            X2 = np.zeros((N, 3), np.float32)
            uv1f = np.zeros((N, 2), np.float32)
            uv2f = np.zeros((N, 2), np.float32)
            isig1 = np.ones(N, np.float32)
            isig2 = np.ones(N, np.float32)
            # RANSAC-inlier BoW pairs keep their stereo-depth geometry
            active[seed_q] = True
            pair_f[seed_q] = seed_f
            X1[seed_q] = X1c[inl]
            X2[seed_q] = X2c[inl]
            uv1f[seed_q] = uv1[inl]
            uv2f[seed_q] = uv2[inl]
            isig1[seed_q] = 1.0 / s2_1[inl]
            isig2[seed_q] = 1.0 / s2_2[inl]
            # mutually grown pairs use their landmark positions mapped
            # into each camera (Optimizer.optimize_sim3 edge geometry)
            g1 = np.nonzero(grown12 >= 0)[0]
            if len(g1):
                g2 = grown12[g1]
                L1 = lm.resolve(ks.obs_lm[kf])[g1]
                L2 = lm.resolve(ks.obs_lm[cand])[g2]
                active[g1] = True
                pair_f[g1] = g2
                X1[g1] = lm.pos[L1] @ T1[:3, :3].T + T1[:3, 3]
                X2[g1] = lm.pos[L2] @ T2[:3, :3].T + T2[:3, 3]
                uv1f[g1] = ks.kp_xy[kf, g1]
                uv2f[g1] = ks.kp_xy[cand, g2]
                isig1[g1] = 1.0 / sigma2[ks.kp_octave[kf, g1]]
                isig2[g1] = 1.0 / sigma2[ks.kp_octave[cand, g2]]

            with trace.stage(self.times, "loop.sim3_opt"):
                U = self._up
                opt = optimize_sim3(
                    U(np.asarray(R_r, np.float32)),
                    U(np.asarray(t_r, np.float32)),
                    U(np.asarray(s_r, np.float32)),
                    U(X1), U(X2), U(uv1f), U(uv2f), U(isig1), U(isig2),
                    U(active), cam4, th2=10.0, fix_scale=True,
                )
                # one read: R (9) | t (3) | s (1) | inliers (N)
                out = _pack_f32(opt.R, opt.t, opt.s, opt.inliers)
                opt_inl = out[13:].astype(bool)
                n_opt_inl = int(opt_inl.sum())
            self.events.append((kf, cand, "sim3_opt", n_opt_inl))
            if n_opt_inl < 20:
                continue

            # Scm maps candidate-camera coords into current-camera coords
            Scm = (out[:9].reshape(3, 3).copy(), out[9:12].copy(), float(out[12]))
            Scw = _sim3_mul(Scm, _sim3_from_T(ks.Tcw[cand]))

            # surviving pairs whose candidate feature carries a live
            # landmark become loop-landmark bindings
            match_map = {}
            for q in np.nonzero(opt_inl & (pair_f >= 0))[0]:
                l2 = int(cand_lm[pair_f[q]])
                if l2 >= 0 and lm.alive[l2]:
                    match_map[int(q)] = l2

            # second projection pass (LoopClosing.py:236-247): project the
            # loop-region point cloud into the current KF with Scw
            # (search_by_projection_ckf_scw_mp, th=10, TH_LOW) and count
            # total MATCHES: the reference accepts at >= 40 matches
            with trace.stage(self.times, "loop.sim3_proj"):
                n_total = len(match_map) + self._project_loop_points(
                    kf, cand, Scw, match_map)
            self.events.append((kf, cand, "total_matches", n_total))
            if n_total >= 40:
                return cand, Scw, match_map
        # every geometric attempt failed: cool their regions down so the
        # next few keyframes do not re-run the same doomed ladder
        for cand in attempted:
            self._sim3_fail.append(
                (set(self.map.covisible_neighbors(cand)) | {cand}, kf))
        return None

    def _search_by_sim3(self, kf: int, cand: int, R12, t12, s12,
                        seed_q: np.ndarray, seed_f: np.ndarray) -> np.ndarray:
        """Mutual Sim3 projection matching between two keyframes
        (ORBMatcher.search_by_sim3:713-848).  Returns per-current-feature
        candidate-feature index (-1 = no mutual match)."""
        ks = self.map.keyframes
        lm = self.map.landmarks
        k = _consts(self.cfg, self.device)
        U = self._up

        def side(kk, seeds):
            ids = lm.resolve(ks.obs_lm[kk])
            has = (ids >= 0) & lm.alive[np.maximum(ids, 0)]
            safe = np.maximum(ids, 0)
            desc = U(lm.desc[safe])
            f_desc = U(ks.kp_desc[kk])
            already = np.zeros(ks.obs_lm.shape[1], bool)
            already[seeds] = True
            return (U(lm.pos[safe]), unpack_bits(desc), popcount(desc),
                    U(has), U(lm.dmin[safe]), U(lm.dmax[safe]), U(already),
                    U(ks.kp_xy[kk]), U(ks.kp_octave[kk]), unpack_bits(f_desc),
                    popcount(f_desc), U(ks.kp_valid[kk]))

        out = match_ops.sim3_mutual_match(
            *side(kf, seed_q), *side(cand, seed_f),
            U(ks.Tcw[kf]), U(ks.Tcw[cand]),
            U(np.asarray(R12, np.float32)), U(np.asarray(t12, np.float32)),
            U(np.asarray(s12, np.float32)),
            k.cam[:4], k.bounds, k.scale_factors,
            log_scale_factor=float(np.log(self.cfg.orb.scale_factor)),
            n_levels=self.cfg.orb.n_levels,
        )
        return out.cpu().numpy()

    def _project_loop_points(self, kf: int, cand: int, Scw,
                             match_map: Dict[int, int]) -> int:
        """search_by_projection_ckf_scw_mp (ORBMatcher.py:850-923): project
        the loop-region landmarks into the current keyframe with Scw
        (th=10, TH_LOW, level window [pred-1, pred]) and bind new matches
        into ``match_map`` (mutated).  Returns the number added."""
        m = self.map
        ks, lm = m.keyframes, m.landmarks
        pts = _region_points(m, cand) - set(match_map.values())
        if not pts:
            return 0
        p_ids = _point_slots(self.cfg, pts)
        safe = np.maximum(p_ids, 0)

        R, t, s = Scw
        Tcw_eq = np.eye(4, dtype=np.float32)   # Scw as SE3 [R | t/s]
        Tcw_eq[:3, :3] = R
        Tcw_eq[:3, 3] = t / s
        f_free = ks.kp_valid[kf].copy()
        f_free[list(match_map)] = False
        U = self._up
        match = fuse_match_step(
            U(lm.pos[safe]), U(lm.desc[safe]), U(lm.normal[safe]),
            U(lm.dmin[safe]), U(lm.dmax[safe]), U(p_ids >= 0),
            U(ks.kp_xy[kf]), U(ks.kp_octave[kf]), None, U(ks.kp_desc[kf]),
            U(f_free), U(ks.u_right[kf]), U(Tcw_eq), self.cfg,
            radius_mult=10.0, level_hi=0, stereo_gate=False,
        ).cpu().numpy()
        n_added = 0
        for slot in np.nonzero(match >= 0)[0]:
            feat = int(match[slot])
            if feat in match_map:
                continue
            match_map[feat] = int(p_ids[slot])
            n_added += 1
        return n_added

    # ------------------------------ correction ------------------------------

    def correct(self, kf: int, loop_kf: int, Scw, match_map: Dict[int, int]):
        ks = self.map.keyframes
        lm = self.map.landmarks
        m = self.map

        # geometry snapshot for the accept / roll-back at the end: a
        # mis-measured Sim3 must never make a well-conditioned map worse.
        # Topology changes (landmark merges, new observations) are kept
        # either way; only the GEOMETRY (poses + positions) is arbitrated,
        # by the map's own reprojection chi2 on the post-fuse topology.
        snap_Tcw = ks.Tcw[: ks.n].copy()
        snap_pos = lm.pos[: lm.n].copy()

        cur_group = [kf] + m.covisible_neighbors(kf)
        Twc = np.linalg.inv(ks.Tcw[kf]).astype(np.float32)

        corrected: Dict[int, Tuple] = {}
        non_corrected: Dict[int, Tuple] = {}
        for ki in cur_group:
            Tiw = ks.Tcw[ki]
            non_corrected[ki] = _sim3_from_T(Tiw)
            corrected[ki] = _sim3_mul(_sim3_from_T(Tiw @ Twc), Scw)

        # remap landmarks of the current group and update poses
        done: Set[int] = set()
        for ki in cur_group:
            Siw_old = non_corrected[ki]
            Swi_corr = _sim3_inv(corrected[ki])
            ids = lm.resolve(ks.obs_lm[ki])
            ids = np.unique(ids[ids >= 0])
            ids = ids[lm.alive[ids]]
            for p in ids:
                p = int(p)
                if p in done:
                    continue
                done.add(p)
                lm.pos[p] = _sim3_map(
                    Swi_corr, _sim3_map(Siw_old, lm.pos[p][None]))[0]
            lm.mark_dirty(ids)
            R, t, s = corrected[ki]
            Tcorr = np.eye(4, dtype=np.float32)
            Tcorr[:3, :3] = R
            Tcorr[:3, 3] = t / s
            ks.Tcw[ki] = Tcorr

        # the bindings before the merges below: a rolled-back correction
        # keeps only the merged bindings its restored geometry agrees with
        bound_before = lm.resolve(ks.obs_lm[: ks.n])

        # replace current-KF landmarks by their matched loop landmarks
        for feat, loop_lm in match_map.items():
            cur_lm = int(ks.obs_lm[kf, feat])
            if cur_lm >= 0 and cur_lm != loop_lm and lm.alive[loop_lm]:
                m.replace_landmark(cur_lm, loop_lm)
            elif cur_lm < 0 and lm.alive[loop_lm]:
                m.core.add_observation(loop_lm, kf, feat)

        # SearchAndFuse (LoopClosing.py:352-367): project the loop-region
        # landmarks into every corrected keyframe with a 4*scale radius and
        # merge duplicates; the loop landmark always wins
        prev_neighbors = {ki: set(m.covisible_neighbors(ki))
                          for ki in cur_group}
        n_fused = self._search_and_fuse(cur_group, loop_kf) or 0

        # refresh covisibility for the corrected group
        for ki in cur_group:
            m.update_connections(ki)

        # loop connections acquired through fusion (LoopClosing.py:329-337):
        # fresh cross-loop covisibility edges feed the essential graph
        loop_connections: Dict[int, Set[int]] = {}
        group_set = set(cur_group)
        for ki in cur_group:
            fresh = set(m.covisible_neighbors(ki)) - prev_neighbors[ki] \
                - group_set
            if fresh:
                loop_connections[ki] = fresh

        # ---------------- essential graph ----------------
        C = ks.n
        # vertex count bucket-padded: padded vertices are FIXED identity
        # poses with no incident edges, inert in the solve
        Cb = 64
        while Cb < C:
            Cb <<= 1
        Rs = np.tile(np.eye(3, dtype=np.float32), (Cb, 1, 1))
        Rs[:C] = ks.Tcw[:C, :3, :3].astype(np.float32)
        tss = np.zeros((Cb, 3), np.float32)
        tss[:C] = ks.Tcw[:C, :3, 3].astype(np.float32)
        ss = np.ones(Cb, np.float32)
        fixed = np.zeros(Cb, bool)
        fixed[loop_kf] = True
        fixed[C:] = True

        e_i, e_j, mR, mt, msc = [], [], [], [], []
        seen_edges: Set[Tuple[int, int]] = set()

        def add_edge(i, j, Siw_i=None, Sjw_j=None):
            key = (min(i, j), max(i, j))
            if key in seen_edges or i == j:
                return
            seen_edges.add(key)
            Si = Siw_i if Siw_i is not None else _sim3_from_T(ks.Tcw[i])
            Sj = Sjw_j if Sjw_j is not None else _sim3_from_T(ks.Tcw[j])
            Sji = _sim3_mul(Sj, _sim3_inv(Si))
            e_i.append(i)
            e_j.append(j)
            mR.append(Sji[0])
            mt.append(Sji[1])
            msc.append(Sji[2])

        # loop edge between current and loop KF (measured with the
        # corrected pose on the current side)
        add_edge(kf, loop_kf)
        # loop connections from fusion (corrected measurements; the
        # minFeat=100 strength cut is applied by the covisibility weight)
        for ki, partners in loop_connections.items():
            for kj in partners:
                if m.covis_weight(ki, kj) >= 100 or kj == loop_kf:
                    add_edge(ki, kj)
        # spanning-tree edges with pre-correction measurements
        for ki in range(1, C):
            parent = m.parent.get(ki)
            if parent is not None:
                Si = non_corrected.get(ki, _sim3_from_T(ks.Tcw[ki]))
                Sj = non_corrected.get(parent, _sim3_from_T(ks.Tcw[parent]))
                add_edge(ki, parent, Si, Sj)
        # strong covisibles (weight >= 100) with pre-correction measurements
        ca, cb, cw = m.core.covis_edges()
        for ki, kj in zip(cb[cw >= 100].tolist(), ca[cw >= 100].tolist()):
            Si = non_corrected.get(ki, _sim3_from_T(ks.Tcw[ki]))
            Sj = non_corrected.get(kj, _sim3_from_T(ks.Tcw[kj]))
            add_edge(ki, kj, Si, Sj)
        # previous loop edges
        for ki, partners in m.loop_edges.items():
            for kj in partners:
                add_edge(ki, kj)

        if len(e_i) >= 2:
            # solver ladder: dense normal-matrix solve for small graphs,
            # matrix-free PCG above the threshold.  The edge count is
            # bucket-padded (valid-masked) so successive loop events keep
            # the solver's shapes few.
            E = len(e_i)
            Eb = 256
            while Eb < E:
                Eb <<= 1
            padE = Eb - E
            e_i_np = np.concatenate(
                [np.array(e_i, np.int32), np.zeros(padE, np.int32)])
            e_j_np = np.concatenate(
                [np.array(e_j, np.int32), np.zeros(padE, np.int32)])
            mR_np = np.concatenate([
                np.stack(mR).astype(np.float32),
                np.tile(np.eye(3, dtype=np.float32), (padE, 1, 1))])
            mt_np = np.concatenate(
                [np.stack(mt).astype(np.float32),
                 np.zeros((padE, 3), np.float32)])
            ms_np = np.concatenate(
                [np.array(msc, np.float32), np.ones(padE, np.float32)])
            e_valid = np.arange(Eb) < E
            big = C > self.cfg.ba.pose_graph_cg_threshold
            mesh = self._pose_graph_mesh(big)
            if mesh is not None:
                from pyorbslam_tpu_torch.parallel import dist_pose_graph

                pe = dist_pose_graph.pad_edges(
                    mesh.n_shards, e_i_np, e_j_np, mR_np, mt_np, ms_np, e_valid)
                reps, shds = dist_pose_graph.place_pose_graph(
                    mesh, [Rs, tss, ss, fixed], list(pe))
                res = dist_pose_graph.distributed_pose_graph(
                    mesh, *reps, *shds, iters=self.cfg.ba.pose_graph_iters,
                    cg_iters=self.cfg.ba.pose_graph_cg_iters)
            else:
                U = self._up
                args = (U(Rs), U(tss), U(ss), U(fixed), U(e_i_np), U(e_j_np),
                        U(mR_np), U(mt_np), U(ms_np), U(e_valid))
                if big:
                    res = optimize_pose_graph_cg(
                        *args, iters=self.cfg.ba.pose_graph_iters,
                        cg_iters=self.cfg.ba.pose_graph_cg_iters)
                else:
                    res = optimize_pose_graph(
                        *args, iters=self.cfg.ba.pose_graph_iters)
            # one read: R (9 Cb) | t (3 Cb) | s (Cb)
            out = _pack_f32(res.R, res.t, res.s)
            newR = out[: 9 * Cb].reshape(Cb, 3, 3)
            newt = out[9 * Cb: 12 * Cb].reshape(Cb, 3)
            news = out[12 * Cb:]

            # landmark correction through reference keyframes
            # (Optimizer.py:643-658), vectorized: map each landmark into
            # its first observer's OLD camera frame, then out through the
            # corrected inverse Sim3
            ids = m.core.observed_landmarks(lm.n)
            if len(ids):
                ref, _ = m.core.first_observers(ids)
                ok = ref >= 0
                ids, ref = ids[ok], ref[ok]
                P = lm.pos[ids]
                R_old = ks.Tcw[ref, :3, :3]
                t_old = ks.Tcw[ref, :3, 3]
                Pc = np.einsum("mij,mj->mi", R_old, P) + t_old
                Rc = newR[ref]
                tc = newt[ref]
                sc = news[ref][:, None]
                lm.pos[ids] = (np.einsum("mji,mj->mi", Rc, Pc - tc) / sc
                               ).astype(np.float32)
                lm.mark_dirty(ids)
            for ki in range(C):
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = newR[ki]
                T[:3, 3] = newt[ki] / news[ki]
                ks.Tcw[ki] = T

        # ---------------- accept / roll-back ----------------
        # Evaluate corrected against snapshot geometry on the SAME
        # (current, post-fuse) topology; keep whichever the map's
        # reprojection chi2 prefers.  The margin biases toward acceptance:
        # a genuine loop closure briefly raises local chi2 until the global
        # BA polishes, so only a clearly worse correction is rolled back.
        with trace.stage(self.times, "loop.accept_check"):
            e_corr = m.reprojection_chi2()
            corr_Tcw = ks.Tcw[: ks.n].copy()
            corr_pos = lm.pos[: lm.n].copy()
            ks.Tcw[: ks.n] = snap_Tcw
            lm.pos[: lm.n] = snap_pos
            e_snap = m.reprojection_chi2()
        self.events.append(
            f"loop:accept_check chi2_corr={e_corr:.2f} chi2_snap={e_snap:.2f}")
        # margin calibration (the JAX package's observed events): harmful
        # corrections score chi2_corr / chi2_snap >= 2.8, genuine loops
        # <= 1.7; 2.5x splits the gap, biased toward acceptance because a
        # genuine loop also buys the loop edge the essential graph needs
        if e_corr <= 2.5 * e_snap + 0.5:
            ks.Tcw[: ks.n] = corr_Tcw
            lm.pos[: lm.n] = corr_pos
            accepted = True
        else:
            # geometry stays at the snapshot, and so do the merged
            # bindings it agrees with.  Those it rejects are erased here
            # (ROADMAP.md queue 3, F6): they are coherent (a whole wrongly
            # fused region), local BA refuses to move a camera meters to
            # fit them and so never gates them out, and a later global BA,
            # which erases nothing, bends the map around them
            accepted = False
            self.n_loops_rejected += 1
            bound = lm.resolve(ks.obs_lm[: ks.n])
            ki, fi = np.nonzero((bound >= 0) & (bound != bound_before)
                                & ks.alive[: ks.n, None])
            ids = bound[ki, fi]
            live = lm.alive[ids]
            n_erased = m.erase_disagreeing(ki[live], fi[live], ids[live])
            self.events.append(f"loop:rolled_back_bindings erased={n_erased} "
                               f"of {int(live.sum())}")
            # a heavily fused rejection still closes the loop functionally
            if n_fused >= 40:
                self.n_loops_fused += 1
        lm.mark_dirty(np.arange(lm.n, dtype=np.int32))

        if not accepted:
            self.last_loop_kf = kf   # detection cooldown applies either way
            return

        m.loop_edges.setdefault(kf, set()).add(loop_kf)
        m.loop_edges.setdefault(loop_kf, set()).add(kf)
        self.last_loop_kf = kf
        self.n_loops_closed += 1

        # ---------------- global BA (bounded slices) ----------------
        # The reference runs global BA on its own thread and aborts it when
        # a new loop arrives (mbStopGBA, LoopClosing.py:342-436).  Here the
        # iteration budget is amortized: one fixed-size slice now, the rest
        # one slice per following keyframe (:meth:`run_gba_slice`); a new
        # loop closure resets the pending budget, which IS the abort.
        self._gba_remaining = self.cfg.ba.gba_iters
        self.run_gba_slice()

    GBA_SLICE = 2   # LM iterations per slice

    def run_gba_slice(self) -> bool:
        """Run one bounded global-BA slice if budget remains; returns True
        if a slice ran.  Each slice re-linearizes, so interleaving slices
        with tracking is safe."""
        remaining = self._gba_remaining
        if remaining <= 0:
            return False
        info = self.map.global_ba(iters=self.GBA_SLICE)
        if not info.get("ran"):
            # a no-op slice (map momentarily too small) must not consume
            # the budget
            return False
        self._gba_remaining = remaining - self.GBA_SLICE
        return True

    def _search_and_fuse(self, cur_group: List[int], loop_kf: int) -> int:
        """Project the loop-region point cloud into each corrected
        keyframe and fuse duplicates (ORBMatcher.fuse_kf_scw_mp semantics:
        radius 4*scale, TH_LOW; the loop landmark replaces the local one).
        Eight target keyframes per program and read."""
        m = self.map
        ks, lm = m.keyframes, m.landmarks
        pts = _region_points(m, loop_kf)
        if not pts:
            return 0
        n_fused = 0
        p_ids = _point_slots(self.cfg, pts)
        safe = np.maximum(p_ids, 0)
        U = self._up
        block = (U(lm.pos[safe]), U(lm.desc[safe]), U(lm.normal[safe]),
                 U(lm.dmin[safe]), U(lm.dmax[safe]), U(p_ids >= 0))

        T = 8
        for c0 in range(0, len(cur_group), T):
            chunk = cur_group[c0:c0 + T]
            sel = np.asarray((chunk + [chunk[0]] * T)[:T])
            matches = fuse_match_batch(
                *block, U(ks.kp_xy[sel]), U(ks.kp_octave[sel]), None,
                U(ks.kp_desc[sel]), U(ks.kp_valid[sel]), U(ks.u_right[sel]),
                U(ks.Tcw[sel]), self.cfg, radius_mult=4.0,
            ).cpu().numpy()
            for ti, target_kf in enumerate(chunk):
                match = matches[ti]
                for slot in np.nonzero(match >= 0)[0]:
                    p = int(p_ids[slot])
                    if p < 0 or not lm.alive[p]:
                        continue
                    p = int(lm.resolve(np.asarray([p]))[0])
                    if p < 0 or not lm.alive[p]:
                        continue
                    feat = int(match[slot])
                    q = int(ks.obs_lm[target_kf, feat])
                    if q == p:
                        continue
                    if q >= 0 and lm.alive[q]:
                        m.replace_landmark(q, p)   # loop point wins
                    else:
                        m.core.add_observation(p, target_kf, feat)
                    n_fused += 1
        return n_fused

    def on_keyframe(self, kf: int, bow: Dict[int, float]) -> bool:
        """Run the full loop-closing pipeline; returns True if a loop was
        closed (LoopClosing.run, one iteration).  Stage wall clock lands
        in ``self.times``."""
        with trace.stage(self.times, "loop.detect"):
            cands = self.detect(kf, bow)
        if not cands:
            return False
        with trace.stage(self.times, "loop.sim3"):
            hit = self.compute_sim3(kf, cands)
        if hit is None:
            return False
        loop_kf, Scw, match_map = hit
        with trace.stage(self.times, "loop.correct"):
            self.correct(kf, loop_kf, Scw, match_map)
        return True
