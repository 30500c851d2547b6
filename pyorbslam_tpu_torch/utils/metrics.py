"""Trajectory accuracy metrics (ATE / RPE).

The reference exports trajectories for *external* evaluation only
(System.py:114-147); this module builds the evaluation in so integration
tests can gate on ATE RMSE directly (SURVEY.md §4 test-pyramid plan).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment mapping src -> dst.

    Returns (s, R, t) minimizing || dst - (s R src + t) ||^2 (Umeyama 1991).
    """
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_wc: np.ndarray, gt_wc: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE between (N,4,4) Twc pose arrays."""
    p_est = est_wc[:, :3, 3]
    p_gt = gt_wc[:, :3, 3]
    if align:
        s, R, t = umeyama_alignment(p_est, p_gt, with_scale=with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    err = p_est - p_gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def rpe(est_wc: np.ndarray, gt_wc: np.ndarray, delta: int = 1) -> Tuple[float, float]:
    """Relative pose error: (translation RMSE in m, rotation RMSE in rad)
    over pose pairs ``delta`` frames apart."""
    n = len(est_wc) - delta
    terr = np.empty(n)
    rerr = np.empty(n)
    for i in range(n):
        de = np.linalg.inv(est_wc[i]) @ est_wc[i + delta]
        dg = np.linalg.inv(gt_wc[i]) @ gt_wc[i + delta]
        e = np.linalg.inv(dg) @ de
        terr[i] = np.linalg.norm(e[:3, 3])
        ang = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr[i] = np.arccos(ang)
    return float(np.sqrt((terr ** 2).mean())), float(np.sqrt((rerr ** 2).mean()))
