"""Absolute trajectory error.  Frozen from
``pyorbslam_tpu_torch/utils/metrics.py`` (``umeyama_alignment``,
``ate_rmse``) at commit 140fb47."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares (s, R, t) minimising || dst - (s R src + t) ||^2
    (Umeyama 1991)."""
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
    """RMSE of the camera centres of (N, 4, 4) Twc arrays, after a rigid
    alignment of the estimate onto the truth."""
    p_est = est_wc[:, :3, 3]
    p_gt = gt_wc[:, :3, 3]
    if align:
        s, R, t = umeyama_alignment(p_est, p_gt, with_scale=with_scale)
        p_est = (s * (R @ p_est.T)).T + t
    err = p_est - p_gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
