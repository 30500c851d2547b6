"""A ``System`` map's global-BA problem tiled to deployment scale.

The port of the tiling in the repository's
``tests/test_dist_gba_scale.py``: the map's live keyframes, observed
landmarks and their observations (gathered through the native core) are
copied rigidly around a 400 m ring until the problem holds at least
``min_cams`` cameras and ``min_obs`` observations, each copy keeping the
map's own covisibility structure, its first keyframe fixed (the gauge) and
the other centres noised by ``NOISE_M`` on each axis.  ``tests/test_torch_dist.py`` runs a small tiling
on the CPU, ``chip_smoke.py`` phase 12 the test's own (>= 512 cameras,
>= 200k observations) on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyorbslam_tpu_torch.optim.ba import BAProblem

NOISE_M = 0.03     # sd of the noise on each copied centre's axes, metres
SEED = 11


class Tiling(NamedTuple):
    prob: BAProblem          # on the CPU, observations in map order
    true_centres: np.ndarray  # (C, 3) camera centres before the noise
    copies: int


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of (N, 3, 3) rotations and (N, 3)
    translations (world to camera).  Errors are measured on centres: far
    from the origin the Tcw translation column amplifies an orientation
    difference by the lever arm."""
    return -np.einsum("nji,nj->ni", np.asarray(R, np.float64),
                      np.asarray(t, np.float64))


def _ring(r: int, n: int, radius: float = 400.0) -> np.ndarray:
    """World->world rigid motion placing copy r on a ring."""
    ang = 2 * np.pi * r / n
    T = np.eye(4)
    T[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                 [-np.sin(ang), 0, np.cos(ang)]]
    T[0, 3] = radius * np.sin(ang)
    T[2, 3] = radius * (1 - np.cos(ang))
    return T


def tile(slam_map, cfg, min_cams: int, min_obs: int, pad_to: int = 1) -> Tiling:
    """The tiled problem of ``slam_map``; P is padded to a multiple of
    ``pad_to`` (the shard count)."""
    ks, lm = slam_map.keyframes, slam_map.landmarks
    cams = np.asarray([k for k in range(ks.n) if ks.alive[k]], np.int32)
    pnt_ids = slam_map.core.observed_landmarks(lm.n)
    oc, op, okf, oft = slam_map.core.assemble_obs(cams, pnt_ids, cap=1 << 20)
    C0, P0, O0 = len(cams), len(pnt_ids), len(oc)
    R = max(-(-min_cams // C0), -(-min_obs // O0))
    C, P = R * C0, -(-R * P0 // pad_to) * pad_to
    isig = np.asarray(cfg.orb.inv_level_sigma2, np.float32)[ks.kp_octave[okf, oft]]
    uvr = np.stack([ks.kp_xy[okf, oft, 0], ks.kp_xy[okf, oft, 1],
                    ks.u_right[okf, oft]], axis=1).astype(np.float32)
    Tcw0 = ks.Tcw[cams].astype(np.float64)
    pos0 = lm.pos[pnt_ids].astype(np.float64)
    rng = np.random.default_rng(SEED)
    cam_Tcw = np.zeros((C, 4, 4), np.float32)
    cam_fixed = np.zeros(C, bool)
    pnt_pos = np.zeros((P, 3), np.float32)
    true_c = np.zeros((C, 3))
    for r in range(R):
        T = _ring(r, R)
        Tcw_r = Tcw0 @ np.linalg.inv(T)
        true_c[r * C0:(r + 1) * C0] = centres(Tcw_r[:, :3, :3], Tcw_r[:, :3, 3])
        noise = rng.normal(0, NOISE_M, (C0, 3))
        noise[0] = 0.0
        Tcw_r[:, :3, 3] += noise
        cam_Tcw[r * C0:(r + 1) * C0] = Tcw_r
        cam_fixed[r * C0] = True          # per-copy gauge anchor
        pnt_pos[r * P0:(r + 1) * P0] = pos0 @ T[:3, :3].T + T[:3, 3]
    c = cfg.camera
    t = torch.from_numpy
    prob = BAProblem(
        cam_Tcw=t(cam_Tcw), cam_fixed=t(cam_fixed), pnt_pos=t(pnt_pos),
        pnt_active=t(np.arange(P) < R * P0),
        obs_cam=t(np.concatenate([oc + r * C0 for r in range(R)]).astype(np.int32)),
        obs_pnt=t(np.concatenate([op + r * P0 for r in range(R)]).astype(np.int32)),
        obs_uvr=t(np.tile(uvr, (R, 1))), obs_inv_sigma2=t(np.tile(isig, R)),
        obs_active=torch.ones(R * O0, dtype=torch.bool),
        cam=t(np.asarray([c.fx, c.fy, c.cx, c.cy, c.bf], np.float32)))
    return Tiling(prob=prob, true_centres=true_c, copies=R)
