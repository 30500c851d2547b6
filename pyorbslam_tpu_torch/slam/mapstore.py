"""Fixed-capacity SoA landmark and keyframe stores on the host.

Port of ``pyorbslam_tpu/slam/mapstore.py`` (reference: MapPoint.py,
KeyFrame.py, Map.py): map state lives in preallocated numpy arrays,
single writer, and the slices a device step needs are uploaded per call.
Descriptors are int32 words with the JAX package's uint32 bits.
Exceeding a capacity raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LandmarkStore:
    """World landmarks (the reference's MapPoint set)."""

    capacity: int
    n: int = 0

    def __post_init__(self):
        c = self.capacity
        self.pos = np.zeros((c, 3), np.float32)        # world position
        self.desc = np.zeros((c, 8), np.int32)         # distinctive descriptor
        self.normal = np.zeros((c, 3), np.float32)     # mean viewing direction
        self.dmin = np.zeros(c, np.float32)            # 0.8 * min scale-inv dist
        self.dmax = np.zeros(c, np.float32)            # 1.2 * max scale-inv dist
        self.n_obs = np.zeros(c, np.int32)
        self.visible = np.ones(c, np.int32)            # found/visible ratio bookkeeping
        self.found = np.ones(c, np.int32)
        self.first_kf = np.full(c, -1, np.int32)
        self.ref_kf = np.full(c, -1, np.int32)
        self.alive = np.zeros(c, bool)
        self.replaced_by = np.full(c, -1, np.int32)    # MapPoint.replace forwarding
        # ids whose device-mirrored fields (pos/desc/normal/dmin/dmax/
        # alive) were written since the last drain: every writer calls
        # mark_dirty so the device mirror can delta-update without an
        # O(capacity) field scan per refresh
        self._dirty_chunks: list = []

    def mark_dirty(self, ids: np.ndarray):
        if len(ids):
            self._dirty_chunks.append(np.asarray(ids, np.int32))

    def drain_dirty(self) -> np.ndarray:
        if not self._dirty_chunks:
            return np.empty(0, np.int32)
        out = np.unique(np.concatenate(self._dirty_chunks))
        self._dirty_chunks = []
        return out

    def add(
        self,
        pos: np.ndarray,
        desc: np.ndarray,
        normal: np.ndarray,
        dist: np.ndarray,
        level: np.ndarray,
        scale_factor: float,
        n_levels: int,
        ref_kf: int,
    ) -> np.ndarray:
        """Append a batch of landmarks; returns their ids.

        Scale-invariance band from the observing level (MapPoint.py:286-292):
        maxDist = dist * scaleFactor[level]; minDist = maxDist /
        scaleFactor[L-1], with the reference's 0.8/1.2 query margins folded
        into dmin/dmax.
        """
        k = len(pos)
        if self.n + k > self.capacity:
            raise RuntimeError(
                f"LandmarkStore capacity {self.capacity} exceeded ({self.n}+{k})"
            )
        ids = np.arange(self.n, self.n + k, dtype=np.int32)
        sf = scale_factor ** level.astype(np.float64)
        max_dist = dist * sf
        min_dist = max_dist / (scale_factor ** (n_levels - 1))
        self.pos[ids] = pos
        self.desc[ids] = desc
        self.normal[ids] = normal
        self.dmin[ids] = 0.8 * min_dist
        self.dmax[ids] = 1.2 * max_dist
        # n_obs starts at 0: observation registration (the native core's
        # add_keyframe / add_observation(s)) is the single counter, with
        # stereo observations counting 2 (MapPoint.py:98-107)
        self.n_obs[ids] = 0
        self.visible[ids] = 1
        self.found[ids] = 1
        self.first_kf[ids] = ref_kf
        self.ref_kf[ids] = ref_kf
        self.alive[ids] = True
        self.n += k
        self.mark_dirty(ids)
        return ids

    def resolve(self, ids: np.ndarray) -> np.ndarray:
        """Follow replace-forwarding (MapPoint.replace protocol)."""
        ids = ids.copy()
        for _ in range(4):  # chains are short
            mask = (ids >= 0) & (self.replaced_by[np.maximum(ids, 0)] >= 0)
            if not mask.any():
                break
            ids[mask] = self.replaced_by[ids[mask]]
        return ids


@dataclasses.dataclass
class KeyFrameStore:
    """Keyframe poses + per-keyframe feature data + observation table.

    The observation structure is dense per keyframe: ``obs_lm[k, i]`` is
    the landmark id observed by feature slot i of keyframe k (-1 = none),
    the array form of MapPoint.observations / KeyFrame.mvpMapPoints.
    """

    capacity: int
    n_features: int
    n: int = 0

    def __post_init__(self):
        c, f = self.capacity, self.n_features
        self.Tcw = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
        self.frame_id = np.full(c, -1, np.int64)
        self.timestamp = np.zeros(c, np.float64)
        self.alive = np.zeros(c, bool)
        # per-KF feature blocks (copied once from the device frame)
        self.kp_xy = np.zeros((c, f, 2), np.float32)
        self.kp_octave = np.zeros((c, f), np.int32)
        self.kp_angle = np.zeros((c, f), np.float32)
        self.kp_desc = np.zeros((c, f, 8), np.int32)
        self.kp_node = np.full((c, f), -1, np.int32)   # vocab node (BoW matching)
        self.kp_valid = np.zeros((c, f), bool)
        self.u_right = np.full((c, f), -1.0, np.float32)
        self.depth = np.full((c, f), -1.0, np.float32)
        self.obs_lm = np.full((c, f), -1, np.int32)

    def add(self, Tcw, frame_id, timestamp, kp_xy, kp_octave, kp_angle,
            kp_desc, kp_valid, u_right, depth, obs_lm, kp_node=None) -> int:
        if self.n >= self.capacity:
            raise RuntimeError(f"KeyFrameStore capacity {self.capacity} exceeded")
        k = self.n
        self.Tcw[k] = Tcw
        self.frame_id[k] = frame_id
        self.timestamp[k] = timestamp
        self.alive[k] = True
        self.kp_xy[k] = kp_xy
        self.kp_octave[k] = kp_octave
        self.kp_angle[k] = kp_angle
        self.kp_desc[k] = kp_desc
        if kp_node is not None:
            self.kp_node[k] = kp_node
        self.kp_valid[k] = kp_valid
        self.u_right[k] = u_right
        self.depth[k] = depth
        self.obs_lm[k] = obs_lm
        self.n += 1
        return k
