"""The scene's own geometry, for checking what the system measured of it:
the depth along a camera ray, and a point's distance to the nearest
surface.  Plain numpy in float64 over the generator's plane list
(infinite or bounded planes with a point ``p0``, normal ``n`` and in-plane
axes ``e1``, ``e2``)."""

from __future__ import annotations

import numpy as np


def ray_depth(planes, Twc: np.ndarray, K: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Camera z-depth of the first surface hit along the rays through
    pixel positions ``xy`` (N, 2) of a camera at ``Twc``; inf where none."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    dirs_c = np.stack([(xy[:, 0] - cx) / fx, (xy[:, 1] - cy) / fy,
                       np.ones(len(xy))], axis=1)
    dirs = dirs_c @ Twc[:3, :3].T
    o = Twc[:3, 3]
    best = np.full(len(xy), np.inf)
    for pl in planes:
        denom = dirs @ pl.n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(np.abs(denom) > 1e-9, ((pl.p0 - o) @ pl.n) / denom, np.inf)
        hit = (t > 0.05) & (t < 400.0) & (t < best)
        if np.isfinite(pl.ext1) or np.isfinite(pl.ext2):
            rel = o + dirs * t[:, None] - pl.p0
            hit &= (np.abs(rel @ pl.e1) <= pl.ext1) & (np.abs(rel @ pl.e2) <= pl.ext2)
        best = np.where(hit, t, best)
    return best        # the ray's z component is 1, so t is the z-depth


def surface_distance(planes, pts: np.ndarray) -> np.ndarray:
    """Distance of each world point (N, 3) to the nearest plane (the
    corridor's planes are unbounded)."""
    d = np.stack([np.abs((pts - pl.p0) @ pl.n) for pl in planes], axis=1)
    return d.min(axis=1)
