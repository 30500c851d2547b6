"""Large-scale bundle adjustment: implicit-Schur preconditioned CG.

Port of ``pyorbslam_tpu/optim/ba_cg.py``.  The dense engine
(:mod:`pyorbslam_tpu_torch.optim.ba`) lays the camera-point coupling out
as a (6C x 3P) matrix, right for local-BA windows.  Global BA after a
loop closure (Optimizer.bundle_adjustment, Optimizer.py:21-121) runs over
all keyframes and landmarks, where that coupling would be gigabytes.
This engine solves the same reduced camera system

    S dc = rhs,   S = Hcc - W Hpp^-1 W^T

without forming S or W densely: S v is three segment sums over the flat
observation list (``index_add_``), preconditioned by the exact 6x6
diagonal blocks of S.  The LM outer loop, the two-phase Huber / chi2
gating schedule and the acceptance rule are the dense engine's, so the
two are interchangeable.  Every loop is a Python loop of eager ops whose
decisions are ``torch.where``: nothing is read back inside a solve.
"""

from __future__ import annotations

import torch

from pyorbslam_tpu_torch.geometry import se3
from pyorbslam_tpu_torch.optim.ba import (
    CHI2_STEREO,
    HUBER_DELTA,
    BAProblem,
    BAResult,
    _bmm,
    _bmv,
    _btb,
    _btv,
    _huber_w,
    _inv3x3,
    _residuals,
    _robust_cost,
)


def _segment_sum(values, ids, n):
    """``jax.ops.segment_sum``: rows of ``values`` summed into ``n`` slots."""
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, ids, values)


def _schur_blocks(prob: BAProblem, cam_Tcw, pnt_pos, active, lam, use_huber):
    """The block pieces of the damped normal equations:
    (Hcc_d, bc, Hpp_inv, bp, W, chi2)."""
    n_cam, n_pnt = cam_Tcw.shape[0], pnt_pos.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_pnt.long()
    dt, dev = pnt_pos.dtype, pnt_pos.device
    e, Jc, Jp, _ = _residuals(prob, cam_Tcw, pnt_pos)
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2
    w = _huber_w(chi2, HUBER_DELTA) if use_huber else torch.ones_like(chi2)
    w = w * prob.obs_inv_sigma2 * active

    Hcc = _segment_sum(w[:, None, None] * _btb(Jc, Jc), oc, n_cam)
    bc = _segment_sum(w[:, None] * _btv(Jc, e), oc, n_cam)
    Hpp = _segment_sum(w[:, None, None] * _btb(Jp, Jp), op, n_pnt)
    bp = _segment_sum(w[:, None] * _btv(Jp, e), op, n_pnt)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = _inv3x3(Hpp_d)
    W = w[:, None, None] * _btb(Jc, Jp)   # (O, 6, 3)
    return Hcc_d, bc, Hpp_inv, bp, W, chi2


def _make_matvec(prob: BAProblem, Hcc_d, Hpp_inv, W, free):
    n_cam, n_pnt = Hcc_d.shape[0], Hpp_inv.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_pnt.long()

    def matvec(v):  # v: (C, 6)
        vf = v * free[:, None]
        y1 = _bmv(Hcc_d, vf)
        wt_v = _segment_sum(_btv(W, vf[oc]), op, n_pnt)     # W^T v
        t = _bmv(Hpp_inv, wt_v)                              # Hpp^-1 W^T v
        y2 = _segment_sum(_bmv(W, t[op]), oc, n_cam)        # (C, 6)
        y = (y1 - y2) * free[:, None]
        return y + v * (1.0 - free)[:, None]                 # identity on fixed

    return matvec


def _pcg(matvec, b, Minv, iters):
    """Block-Jacobi preconditioned CG on a (C, k) vector space; a lane
    stops moving once its residual has fallen 1e-12 below the start
    (``torch.where``, no read-back)."""

    def dot(a, c):
        return torch.sum(a * c)

    x = torch.zeros_like(b)
    r = b
    z = _bmv(Minv, r)
    p = z
    rz = dot(r, z)
    b_norm = torch.clamp(dot(b, b), min=1e-30)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        live = (dot(r, r) / b_norm) > 1e-12     # freeze once converged
        Ap = matvec(p)
        alpha = rz / torch.clamp(dot(p, Ap), min=1e-30)
        alpha = torch.where(live, alpha, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = _bmv(Minv, r)
        rz_new = dot(r, z)
        beta = torch.where(live, rz_new / torch.clamp(rz, min=1e-30), zero)
        p = z + beta * p
        rz = rz_new
    return x


def _lm_iteration_cg(prob: BAProblem, cam_Tcw, pnt_pos, active, lam,
                     use_huber, cg_iters):
    n_cam, n_pnt = cam_Tcw.shape[0], pnt_pos.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_pnt.long()
    dt, dev = pnt_pos.dtype, pnt_pos.device
    free = (~prob.cam_fixed).to(dt)

    Hcc_d, bc, Hpp_inv, bp, W, chi2 = _schur_blocks(
        prob, cam_Tcw, pnt_pos, active, lam, use_huber)
    matvec = _make_matvec(prob, Hcc_d, Hpp_inv, W, free)

    # rhs = bc - W Hpp^-1 bp, zeroed on fixed cameras
    t = _bmv(Hpp_inv, bp)
    rhs = (bc - _segment_sum(_bmv(W, t[op]), oc, n_cam)) * free[:, None]

    # exact 6x6 diagonal blocks of S for the preconditioner
    WHW = _segment_sum(_bmm(_bmm(W, Hpp_inv[op]), W.transpose(-1, -2)),
                       oc, n_cam)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    S_diag = ((Hcc_d - WHW) * free[:, None, None]
              + eye6 * (1.0 - free)[:, None, None] + 1e-8 * eye6)
    Minv = torch.linalg.inv_ex(S_diag).inverse   # no status read-back

    dc = -_pcg(matvec, rhs, Minv, cg_iters) * free[:, None]

    # back-substitute landmarks
    Wt_dc = _segment_sum(_btv(W, dc[oc]), op, n_pnt)
    dp = -_bmv(Hpp_inv, bp + Wt_dc) * prob.pnt_active[:, None]

    cam_new = se3.retract(cam_Tcw, dc)
    cam_new = torch.where(prob.cam_fixed[:, None, None], cam_Tcw, cam_new)
    pnt_new = pnt_pos + dp

    # the current state's cost reuses this iteration's chi2; the
    # candidate takes the Jacobian-free light path
    cost_old = torch.sum(_robust_cost(chi2, HUBER_DELTA, use_huber) * active)
    e2, _, _, _ = _residuals(prob, cam_new, pnt_new, light=True)
    c2 = torch.sum(e2 * e2, dim=-1) * prob.obs_inv_sigma2
    cost_new = torch.sum(_robust_cost(c2, HUBER_DELTA, use_huber) * active)
    improved = cost_new < cost_old
    cam_out = torch.where(improved, cam_new, cam_Tcw)
    pnt_out = torch.where(improved, pnt_new, pnt_pos)
    return cam_out, pnt_out, torch.where(improved, lam * 0.5, lam * 5.0)


def bundle_adjust_cg(prob: BAProblem, iters1: int = 5, iters2: int = 10,
                     cg_iters: int = 64) -> BAResult:
    """Drop-in replacement for :func:`ba.bundle_adjust` at global scale:
    the same two-phase Huber / gating schedule (Optimizer.py:318-353),
    inexact LM steps by preconditioned CG on the implicit Schur
    complement."""
    active = prob.obs_active.to(prob.pnt_pos.dtype)

    def phase(cT, pP, iters, use_huber, act):
        lam = 1e-4
        for _ in range(iters):
            cT, pP, lam = _lm_iteration_cg(prob, cT, pP, act, lam,
                                           use_huber, cg_iters)
        return cT, pP

    def gate(cT, pP):
        e, _, _, z = _residuals(prob, cT, pP, light=True)
        return torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2, z

    cam_Tcw, pnt_pos = phase(prob.cam_Tcw, prob.pnt_pos, iters1, True, active)
    chi2, z = gate(cam_Tcw, pnt_pos)
    good = (chi2 <= CHI2_STEREO) & (z > 0)
    cam_Tcw, pnt_pos = phase(cam_Tcw, pnt_pos, iters2, False,
                             active * good.to(active.dtype))
    chi2, z = gate(cam_Tcw, pnt_pos)
    depth_ok = z > 0
    inlier = prob.obs_active & (chi2 <= CHI2_STEREO) & depth_ok
    return BAResult(cam_Tcw=cam_Tcw, pnt_pos=pnt_pos, obs_chi2=chi2,
                    obs_depth_ok=depth_ok, obs_inlier=inlier)
