"""Fixed-capacity SoA landmark store on the host.

Port of ``LandmarkStore`` from ``pyorbslam_tpu/slam/mapstore.py``
(reference: MapPoint.py): landmark state lives in preallocated numpy
arrays, single writer, and the slices a device step needs are uploaded
per call.  Descriptors are int32 words with the JAX package's uint32
bits.  Exceeding the capacity raises.
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
        self.n_obs[ids] = 0
        self.visible[ids] = 1
        self.found[ids] = 1
        self.first_kf[ids] = ref_kf
        self.ref_kf[ids] = ref_kf
        self.alive[ids] = True
        self.n += k
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
