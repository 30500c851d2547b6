"""Device-resident ring cache of recent keyframes' feature blocks.

Port of ``pyorbslam_tpu/slam/kf_ring.py``.  Local mapping (triangulation
against covisible neighbors, duplicate fuse) repeatedly needs the
per-feature arrays of recent keyframes on the device.  The host
KeyFrameStore stays authoritative, but keyframe features are immutable
after extraction, so the System inserts every new keyframe's device frame
into this ring once, and the maintenance step gathers neighbors by ring
slot: the feature blocks never cross the host boundary again.  Keyframes
that age out of the ring (beyond the last R) fall back to the host-upload
path.

The JAX package's donated functional insert becomes an in-place write
into tensors preallocated at the first insert.  This is the analog of the
reference's shared-memory access to KeyFrame objects from the
LocalMapping thread (LocalMapping.py:152-308).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.slam.frame import StereoFrame


class DeviceKFRing:
    """Ring of the last R keyframes' feature blocks on the device.

    ``arrays`` is a tuple of (R, N, ...) tensors:
    (xy, octave, desc, u_right, depth, valid).
    """

    # 32 slots cover the deepest covisible target set (1 + 4 triangulation
    # neighbors + 8 fuse targets) with headroom at fast-motion keyframe
    # density.
    def __init__(self, capacity: int = 32):
        self.R = capacity
        self.arrays: Optional[Tuple[torch.Tensor, ...]] = None
        self.slot_of: Dict[int, int] = {}
        self._kf_at = [-1] * capacity
        self._next = 0

    def reset(self):
        self.arrays = None
        self.slot_of.clear()
        self._kf_at = [-1] * self.R
        self._next = 0

    def insert(self, kf: int, frame: StereoFrame):
        n = frame.capacity
        if self.arrays is None:
            R, dev = self.R, frame.xy.device
            self.arrays = (
                torch.zeros((R, n, 2), dtype=torch.float32, device=dev),
                torch.zeros((R, n), dtype=torch.int32, device=dev),
                torch.zeros((R, n, 8), dtype=torch.int32, device=dev),
                torch.full((R, n), -1.0, dtype=torch.float32, device=dev),
                torch.full((R, n), -1.0, dtype=torch.float32, device=dev),
                torch.zeros((R, n), dtype=torch.bool, device=dev),
            )
        slot = self._next
        self._next = (self._next + 1) % self.R
        if self._kf_at[slot] >= 0:
            self.slot_of.pop(self._kf_at[slot], None)
        for dst, src in zip(self.arrays, (frame.xy, frame.octave, frame.desc,
                                          frame.u_right, frame.depth,
                                          frame.valid)):
            dst[slot] = src          # in place: the ring owns its tensors
        self.slot_of[kf] = slot
        self._kf_at[slot] = kf

    def slots_for(self, kfs: List[int]) -> Optional[np.ndarray]:
        """Ring slots for the given keyframes, or None if any is absent."""
        try:
            return np.asarray([self.slot_of[k] for k in kfs], np.int32)
        except KeyError:
            return None
