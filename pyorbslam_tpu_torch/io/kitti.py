"""KITTI odometry stereo sequence IO (numpy only).

The port's own copy of ``pyorbslam_tpu/io/kitti.py``.  Mirrors the
reference CLI data contract: sequences live in
``<path>/image_2`` (left), ``<path>/image_3`` (right) with ``times.txt``
(reference: stereo_kitti.py:24-31 LoadImages), and trajectories are written
as 3x4 row-major camera-to-world matrices, one line per frame
(reference: System.save_trajectory_kitti, System.py:114-147).
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def load_image_paths(sequence_path: str) -> Tuple[List[str], List[str], np.ndarray]:
    """Return (left_paths, right_paths, timestamps) for a KITTI sequence dir."""
    times_file = os.path.join(sequence_path, "times.txt")
    with open(times_file) as f:
        timestamps = np.array([float(line) for line in f if line.strip()], dtype=np.float64)
    left_dir = os.path.join(sequence_path, "image_2")
    right_dir = os.path.join(sequence_path, "image_3")
    n = len(timestamps)
    left = [os.path.join(left_dir, f"{i:06d}.png") for i in range(n)]
    right = [os.path.join(right_dir, f"{i:06d}.png") for i in range(n)]
    return left, right, timestamps


def read_grayscale(path: str) -> np.ndarray:
    """Load an image as uint8 grayscale HxW (KITTI's native dtype - and
    a 4x cheaper host->device transfer than float32; the frontend casts
    to f32 on device)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img


def iter_stereo(sequence_path: str) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    left, right, times = load_image_paths(sequence_path)
    for lp, rp, t in zip(left, right, times):
        yield read_grayscale(lp), read_grayscale(rp), float(t)


def save_trajectory_kitti(path: str, poses_cw: Sequence[np.ndarray]) -> None:
    """Write camera trajectory in the KITTI 3x4 row-major format.

    ``poses_cw`` are world->camera Tcw (the tracker's native output); KITTI
    stores camera->world, so each pose is inverted before writing - the same
    Rwc = Rcw^T / twc = -Rwc tcw chaining the reference performs
    (System.py:124-147).
    """
    with open(path, "w") as f:
        for Tcw in poses_cw:
            Tcw = np.asarray(Tcw, dtype=np.float64)
            Rwc = Tcw[:3, :3].T
            twc = -Rwc @ Tcw[:3, 3]
            row = np.hstack([Rwc, twc.reshape(3, 1)]).reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def load_trajectory_kitti(path: str) -> np.ndarray:
    """Read a KITTI-format trajectory/ground-truth file -> (N, 4, 4) Twc."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    n = rows.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :4] = rows
    return out
