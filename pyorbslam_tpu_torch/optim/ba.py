"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Port of ``pyorbslam_tpu/optim/ba.py``.  Replaces g2o's BlockSolver +
``set_marginalized(True)`` landmark marginalization (used by
Optimizer.local_bundle_adjustment:210-366 and bundle_adjustment:21-121)
with dense device linear algebra:

  * per-observation stereo residuals/Jacobians (EdgeStereoSE3ProjectXYZ,
    edge_project_stereo_xyz.cpp:33-89) are computed for all edges at once;
  * the block-sparse normal equations are reduced by the Schur complement:
    3x3 landmark blocks are inverted batched, the camera-point coupling
    blocks W are laid into a dense (6C x 3P) matrix, and the reduced
    camera system S = Hcc - W Hpp^-1 W^T is one matrix product, solved
    with ``torch.linalg.solve_ex`` (no status read-back);
  * the reference's two-phase schedule is preserved: 5 Huber iterations,
    chi2/depth gating that *excludes* bad edges and drops the robust
    kernel, 10 more iterations, then a final gate marking observations to
    erase (Optimizer.py:318-353).

Shapes are fixed in (C cams, P points, O observations or a (P, K) grid);
padding rides along with zero weight.  float32 throughout (TF32 off, see
``utils/precision``) with multiplicative LM damping.  The LM
accept/reject decision is a ``torch.where`` on device scalars, so a solve
reads nothing back to the host until its caller does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyorbslam_tpu_torch.geometry import se3

CHI2_STEREO = 7.815
HUBER_DELTA = float(np.sqrt(CHI2_STEREO))


class BAProblem(NamedTuple):
    """Fixed-shape BA problem tensors."""

    cam_Tcw: torch.Tensor       # (C, 4, 4)
    cam_fixed: torch.Tensor     # (C,) bool (includes padding slots)
    pnt_pos: torch.Tensor       # (P, 3)
    pnt_active: torch.Tensor    # (P,) bool
    obs_cam: torch.Tensor       # (O,) int32
    obs_pnt: torch.Tensor       # (O,) int32
    obs_uvr: torch.Tensor       # (O, 3)
    obs_inv_sigma2: torch.Tensor  # (O,)
    obs_active: torch.Tensor    # (O,) bool
    cam: torch.Tensor           # (5,) [fx, fy, cx, cy, bf]


class BAResult(NamedTuple):
    cam_Tcw: torch.Tensor
    pnt_pos: torch.Tensor
    obs_chi2: torch.Tensor      # final per-observation chi2
    obs_depth_ok: torch.Tensor  # final per-observation depth > 0
    obs_inlier: torch.Tensor    # survived the final gate


def _bmv(A, x):
    """Batched (..., i, j) @ (..., j) as broadcast-multiply-sum: the inner
    dims here are 3/6, far below what a batched matmul library call is
    built for, and the broadcast form keeps exact float32."""
    return torch.sum(A * x[..., None, :], dim=-1)


def _bmm(A, B):
    """Batched (..., i, j) @ (..., j, k); see :func:`_bmv`."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _btb(A, B):
    """Batched A^T B: (..., i, j), (..., i, k) -> (..., j, k)."""
    return torch.sum(A[..., :, :, None] * B[..., :, None, :], dim=-3)


def _btv(A, x):
    """Batched A^T x: (..., i, j), (..., i) -> (..., j)."""
    return torch.sum(A * x[..., :, None], dim=-2)


def _project(Pc, uvr, cam, light: bool, R):
    """Shared projection body: residuals e (..., 3), depth z (...), and
    unless ``light`` the Jacobians Jc (..., 3, 6), Jp (..., 3, 3)."""
    fx, fy, cx, cy, bf = (cam[i] for i in range(5))
    x, y, z = Pc[..., 0], Pc[..., 1], Pc[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    invz = 1.0 / zsafe
    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bf * invz
    e = uvr - torch.stack([u, v, ur], dim=-1)
    if light:
        return e, None, None, z
    invz2 = invz * invz
    zeros = torch.zeros_like(x)
    du = torch.stack([fx * invz, zeros, -fx * x * invz2], dim=-1)
    dv = torch.stack([zeros, fy * invz, -fy * y * invz2], dim=-1)
    dur = du + torch.stack([zeros, zeros, bf * invz2], dim=-1)
    dh_dp = torch.stack([du, dv, dur], dim=-2)            # (..., 3, 3)
    eye = torch.eye(3, dtype=Pc.dtype, device=Pc.device).expand(
        Pc.shape[:-1] + (3, 3))
    dp_dxi = torch.cat([-se3.hat(Pc), eye], dim=-1)       # (..., 3, 6)
    Jc = -_bmm(dh_dp, dp_dxi)
    Jp = -_bmm(dh_dp, R)
    return e, Jc, Jp, z


def _residuals(prob: BAProblem, cam_Tcw, pnt_pos, light: bool = False):
    """Residuals (O, 3), Jacobians Jc (O, 3, 6), Jp (O, 3, 3), depth (O,).
    With ``light`` the Jacobians are skipped (the cost-evaluation path of
    the LM accept/reject test and the phase gates)."""
    T = cam_Tcw[prob.obs_cam.long()]            # (O, 4, 4)
    X = pnt_pos[prob.obs_pnt.long()]            # (O, 3)
    R = T[:, :3, :3]
    Pc = _bmv(R, X) + T[:, :3, 3]
    return _project(Pc, prob.obs_uvr, prob.cam, light, R)


def _huber_w(chi2, delta):
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= delta * delta, torch.ones_like(chi2), delta / s)


def _robust_cost(chi2, delta, use_huber):
    if not use_huber:
        return chi2
    s = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= delta * delta, chi2, 2 * delta * s - delta * delta)


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([D, E, F], -1),
        torch.stack([G, H, I], -1),
    ], -2)
    return adj / det[..., None, None]


def _solve_reduced(Hcc_d, S_sub, rhs, cam_fixed):
    """dc (C, 6) from the reduced camera system: block-diagonal damped
    Hcc minus the Schur term, fixed / padded cameras frozen to identity
    rows and columns with zero right-hand side."""
    n_cam = Hcc_d.shape[0]
    Hcc_bd = torch.zeros((n_cam, 6, n_cam, 6), dtype=Hcc_d.dtype,
                         device=Hcc_d.device)
    idx = torch.arange(n_cam, device=Hcc_d.device)
    Hcc_bd[idx, :, idx, :] = Hcc_d          # block-diagonal write
    S_red = Hcc_bd.reshape(n_cam * 6, n_cam * 6) - S_sub
    free6 = (~cam_fixed).to(Hcc_d.dtype).repeat_interleave(6)
    S_red = S_red * free6[:, None] * free6[None, :] + torch.diag(1.0 - free6)
    rhs = rhs * free6
    # solve_ex: ``linalg.solve`` on a CUDA tensor reads its status flag
    # back and waits for the device; the damped, identity-padded system
    # is never singular, and the JAX package's solve checks nothing either
    return -torch.linalg.solve_ex(S_red, rhs).result.reshape(n_cam, 6)


def _accept(cam_Tcw, pnt_pos, cam_new, pnt_new, lam, cost_old, cost_new):
    """LM accept / reject on the total robust cost, on the device."""
    improved = cost_new < cost_old
    cam_out = torch.where(improved, cam_new, cam_Tcw)
    pnt_out = torch.where(improved, pnt_new, pnt_pos)
    lam = torch.where(improved, lam * 0.5, lam * 5.0)
    return cam_out, pnt_out, lam


def _lm_iteration(prob: BAProblem, cam_Tcw, pnt_pos, active, lam, use_huber):
    n_cam = cam_Tcw.shape[0]
    n_pnt = pnt_pos.shape[0]
    oc = prob.obs_cam.long()
    op = prob.obs_pnt.long()
    dt, dev = pnt_pos.dtype, pnt_pos.device

    e, Jc, Jp, z = _residuals(prob, cam_Tcw, pnt_pos)
    chi2 = torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2
    w = _huber_w(chi2, HUBER_DELTA) if use_huber else torch.ones_like(chi2)
    w = w * prob.obs_inv_sigma2 * active

    Hcc = torch.zeros((n_cam, 6, 6), dtype=dt, device=dev).index_add_(
        0, oc, w[:, None, None] * _btb(Jc, Jc))
    bc = torch.zeros((n_cam, 6), dtype=dt, device=dev).index_add_(
        0, oc, w[:, None] * _btv(Jc, e))
    Hpp = torch.zeros((n_pnt, 3, 3), dtype=dt, device=dev).index_add_(
        0, op, w[:, None, None] * _btb(Jp, Jp))
    bp = torch.zeros((n_pnt, 3), dtype=dt, device=dev).index_add_(
        0, op, w[:, None] * _btv(Jp, e))

    # multiplicative LM damping on both block diagonals
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = _inv3x3(Hpp_d)

    W = w[:, None, None] * _btb(Jc, Jp)         # (O, 6, 3)
    WHinv = _bmm(W, Hpp_inv[op])                # (O, 6, 3)

    def dense(blocks):
        out = torch.zeros((n_cam, n_pnt, 6, 3), dtype=dt, device=dev)
        out.index_put_((oc, op), blocks, accumulate=True)
        return out.permute(0, 2, 1, 3).reshape(n_cam * 6, n_pnt * 3)

    A2 = dense(W)
    M2 = dense(WHinv)
    rhs = bc.reshape(-1) - M2 @ bp.reshape(-1)
    dc = _solve_reduced(Hcc_d, M2 @ A2.T, rhs, prob.cam_fixed)

    # back-substitute points: dp = -Hpp^-1 (bp + sum_o W^T dc[cam_o])
    Wt_dc = _btv(W, dc[oc])                     # (O, 3)
    acc = torch.zeros((n_pnt, 3), dtype=dt, device=dev).index_add_(0, op, Wt_dc)
    dp = -_bmv(Hpp_inv, bp + acc)
    dp = dp * prob.pnt_active[:, None]

    cam_new = se3.retract(cam_Tcw, dc)
    cam_new = torch.where(prob.cam_fixed[:, None, None], cam_Tcw, cam_new)
    pnt_new = pnt_pos + dp

    # the current state's cost reuses the chi2 from the top of this
    # iteration; the candidate takes the Jacobian-free light path
    cost_old = torch.sum(_robust_cost(chi2, HUBER_DELTA, use_huber) * active)
    e2, _, _, _ = _residuals(prob, cam_new, pnt_new, light=True)
    c2 = torch.sum(e2 * e2, dim=-1) * prob.obs_inv_sigma2
    cost_new = torch.sum(_robust_cost(c2, HUBER_DELTA, use_huber) * active)
    return _accept(cam_Tcw, pnt_pos, cam_new, pnt_new, lam, cost_old, cost_new)


class BAGridProblem(NamedTuple):
    """The dense BA layout: observations as a (P, K) grid; row p holds
    point p's observations in slots 0..K-1 (inactive slots padded).  K is
    the max observations per point (<= C).  Every reduction the Schur
    solve needs then becomes a plain axis sum or an einsum: no scatters,
    no segment ids, no point gathers."""

    cam_Tcw: torch.Tensor       # (C, 4, 4)
    cam_fixed: torch.Tensor     # (C,) bool
    pnt_pos: torch.Tensor       # (P, 3)
    pnt_active: torch.Tensor    # (P,) bool
    g_cam: torch.Tensor         # (P, K) int32 camera per slot
    g_uvr: torch.Tensor         # (P, K, 3)
    g_isig: torch.Tensor        # (P, K)
    g_act: torch.Tensor         # (P, K) bool
    cam: torch.Tensor           # (5,)


class BAGridResult(NamedTuple):
    cam_Tcw: torch.Tensor
    pnt_pos: torch.Tensor
    g_chi2: torch.Tensor        # (P, K) final chi2 per grid slot
    g_depth_ok: torch.Tensor    # (P, K)
    g_inlier: torch.Tensor      # (P, K)


def _grid_slots(op: np.ndarray, K: int):
    first = np.searchsorted(op, op)
    slot = (np.arange(len(op)) - first).astype(np.int32)
    kept = slot < K
    return slot, kept, int((~kept).sum())


def grid_from_obs(oc: np.ndarray, op: np.ndarray, ouvr: np.ndarray,
                  oisig: np.ndarray, n_pnt: int, K: int = 8):
    """Host-side (numpy) layout of flat observations into the dense
    (P, K) grid.  Returns (g_cam, g_uvr, g_isig, g_act, slot, kept,
    n_dropped): ``slot[i]``/``kept[i]`` map flat observation i to its
    grid cell for reading per-observation results back.  Observations
    must be sorted by point id.

    K is fixed (default 8): the mean observation count per point is
    ~2-3, so sizing K to the max (a few heavily-observed points) would
    pad the grid to a few percent utilization.  A point's observations
    beyond K are dropped from the problem; those points are the
    over-determined ones, and the erase pass treats dropped slots as
    inliers (never erased on grid evidence)."""
    slot, kept, n_dropped = _grid_slots(op, K)
    g_cam = np.zeros((n_pnt, K), np.int32)
    g_uvr = np.zeros((n_pnt, K, 3), np.float32)
    g_isig = np.zeros((n_pnt, K), np.float32)
    g_act = np.zeros((n_pnt, K), bool)
    pk, kk = op[kept], slot[kept]
    g_cam[pk, kk] = oc[kept]
    g_uvr[pk, kk] = ouvr[kept]
    g_isig[pk, kk] = oisig[kept]
    g_act[pk, kk] = True
    return g_cam, g_uvr, g_isig, g_act, slot, kept, n_dropped


UVR_Q = 16.0   # fixed-point scale for packed (u, v, u_r): 1/16 px


def _to_int16(values: np.ndarray, what: str) -> np.ndarray:
    """Cast to int16, raising on a value the type cannot hold."""
    info = np.iinfo(np.int16)
    if len(values) and (values.min() < info.min or values.max() > info.max):
        raise ValueError(
            f"grid_pack_from_obs: {what} outside int16 "
            f"[{values.min()}, {values.max()}]")
    return values.astype(np.int16)


def grid_pack_from_obs(oc: np.ndarray, op: np.ndarray, ouvr: np.ndarray,
                       ooct: np.ndarray, n_pnt: int, K: int = 8):
    """Like :func:`grid_from_obs` but laid out in the packed upload
    dtypes: camera ids int16, (u, v, u_r) as 1/16-px int16 fixed point,
    per-slot octave uint8 (the inverse-sigma2 is a tiny per-octave
    table, looked up on the device).  Per-slot bytes drop 21 -> 10.
    Quantization error <= 1/32 px, an order below the finest measurement
    sigma (1 px at octave 0).  A camera id or a coordinate outside int16
    (|coordinate| >= 2048 px) raises instead of wrapping."""
    slot, kept, n_dropped = _grid_slots(op, K)
    g_cam = np.zeros((n_pnt, K), np.int16)
    g_uvrq = np.zeros((n_pnt, K, 3), np.int16)
    g_oct = np.zeros((n_pnt, K), np.uint8)
    g_act = np.zeros((n_pnt, K), bool)
    pk, kk = op[kept], slot[kept]
    g_cam[pk, kk] = _to_int16(np.asarray(oc[kept]), "camera id")
    g_uvrq[pk, kk] = _to_int16(np.round(ouvr[kept] * UVR_Q), "pixel coordinate")
    g_oct[pk, kk] = ooct[kept].astype(np.uint8)
    g_act[pk, kk] = True
    return g_cam, g_uvrq, g_oct, g_act, slot, kept, n_dropped


def bundle_adjust_grid_packed(cam_Tcw, cam_fixed, pnt_pos, pnt_active,
                              g_cam16, g_uvrq16, g_oct8, g_act, cam,
                              isig_table, iters1: int = 5,
                              iters2: int = 10) -> BAGridResult:
    """Device-side unpack of :func:`grid_pack_from_obs` + the standard
    grid solve: same math as :func:`bundle_adjust_grid`, half the
    host->device bytes."""
    prob = BAGridProblem(
        cam_Tcw=cam_Tcw, cam_fixed=cam_fixed,
        pnt_pos=pnt_pos, pnt_active=pnt_active,
        g_cam=g_cam16.to(torch.int32),
        g_uvr=g_uvrq16.to(torch.float32) * (1.0 / UVR_Q),
        g_isig=isig_table[g_oct8.long()],
        g_act=g_act, cam=cam)
    return bundle_adjust_grid(prob, iters1=iters1, iters2=iters2)


def _grid_residuals(prob: BAGridProblem, cam_Tcw, pnt_pos, light=False):
    """Grid residuals: e (P, K, 3), Jc (P, K, 3, 6), Jp (P, K, 3, 3),
    z (P, K).  Points broadcast along K: no per-observation gather."""
    T = cam_Tcw[prob.g_cam.long()]               # (P, K, 4, 4)
    R = T[..., :3, :3]
    Pc = _bmv(R, pnt_pos[:, None, :]) + T[..., :3, 3]
    return _project(Pc, prob.g_uvr, prob.cam, light, R)


def _grid_lm_iteration(prob: BAGridProblem, cam_Tcw, pnt_pos, active,
                       lam, use_huber):
    n_cam = cam_Tcw.shape[0]
    P, K = prob.g_cam.shape
    dt, dev = pnt_pos.dtype, pnt_pos.device
    g_cam = prob.g_cam.long()

    e, Jc, Jp, z = _grid_residuals(prob, cam_Tcw, pnt_pos)
    chi2 = torch.sum(e * e, dim=-1) * prob.g_isig
    w = _huber_w(chi2, HUBER_DELTA) if use_huber else torch.ones_like(chi2)
    w = w * prob.g_isig * active                     # (P, K)

    onehot01 = (g_cam[..., None]
                == torch.arange(n_cam, device=dev)).to(dt)   # (P, K, C)
    onehot = onehot01 * w[..., None]                 # weighted

    # camera blocks: one einsum each, no scatters
    JcJc = _btb(Jc, Jc)                              # (P, K, 6, 6)
    Jce = _btv(Jc, e)                                # (P, K, 6)
    Hcc = torch.einsum("pkc,pkij->cij", onehot, JcJc)
    bc = torch.einsum("pkc,pki->ci", onehot, Jce)
    # point blocks: plain K-axis sums
    Hpp = torch.sum(w[..., None, None] * _btb(Jp, Jp), dim=1)   # (P, 3, 3)
    bp = torch.sum(w[..., None] * _btv(Jp, e), dim=1)           # (P, 3)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = _inv3x3(Hpp_d)

    W = w[..., None, None] * _btb(Jc, Jp)            # (P, K, 6, 3)
    WHinv = _bmm(W, Hpp_inv[:, None])                # (P, K, 6, 3)

    # per-point camera-stacked blocks via one-hot einsum (the scatter
    # the flat layout needs), then the reduced system as one product
    A = torch.einsum("pkc,pkix->pcix", onehot01, W)       # (P, C, 6, 3)
    M = torch.einsum("pkc,pkix->pcix", onehot01, WHinv)   # (P, C, 6, 3)
    A2 = A.permute(1, 2, 0, 3).reshape(n_cam * 6, P * 3)
    M2 = M.permute(1, 2, 0, 3).reshape(n_cam * 6, P * 3)
    rhs = bc.reshape(-1) - M2 @ bp.reshape(-1)
    dc = _solve_reduced(Hcc_d, M2 @ A2.T, rhs, prob.cam_fixed)

    # back-substitute: dp = -Hpp^-1 (bp + sum_k W^T dc[cam])
    Wt_dc = _btv(W, dc[g_cam])                       # (P, K, 3)
    dp = -_bmv(Hpp_inv, bp + torch.sum(Wt_dc, dim=1))
    dp = dp * prob.pnt_active[:, None]

    cam_new = se3.retract(cam_Tcw, dc)
    cam_new = torch.where(prob.cam_fixed[:, None, None], cam_Tcw, cam_new)
    pnt_new = pnt_pos + dp

    cost_old = torch.sum(_robust_cost(chi2, HUBER_DELTA, use_huber) * active)
    e2, _, _, _ = _grid_residuals(prob, cam_new, pnt_new, light=True)
    c2 = torch.sum(e2 * e2, dim=-1) * prob.g_isig
    cost_new = torch.sum(_robust_cost(c2, HUBER_DELTA, use_huber) * active)
    return _accept(cam_Tcw, pnt_pos, cam_new, pnt_new, lam, cost_old, cost_new)


def _two_phase(prob, step, residuals, isig, act_mask, iters1, iters2):
    """The reference's two-phase gating schedule (Optimizer.py:318-353)
    around an LM step; shared by the grid and the flat layout.  Returns
    (cam_Tcw, pnt_pos, chi2, depth_ok, inlier)."""
    active = act_mask.to(prob.pnt_pos.dtype)

    def phase(cT, pP, iters, use_huber, act):
        # a Python float: a 0-dim tensor made from the host here would be
        # an upload that waits for the work queued before it
        lam = 1e-4
        for _ in range(iters):
            cT, pP, lam = step(prob, cT, pP, act, lam, use_huber)
        return cT, pP

    def gate(cT, pP):
        e, _, _, z = residuals(prob, cT, pP, light=True)
        return torch.sum(e * e, dim=-1) * isig, z

    cam_Tcw, pnt_pos = phase(prob.cam_Tcw, prob.pnt_pos, iters1, True, active)
    # gate: chi2 > 7.815 or non-positive depth -> exclude; kernel dropped
    chi2, z = gate(cam_Tcw, pnt_pos)
    good = (chi2 <= CHI2_STEREO) & (z > 0)
    cam_Tcw, pnt_pos = phase(cam_Tcw, pnt_pos, iters2, False,
                             active * good.to(active.dtype))
    chi2, z = gate(cam_Tcw, pnt_pos)
    depth_ok = z > 0
    inlier = act_mask & (chi2 <= CHI2_STEREO) & depth_ok
    return cam_Tcw, pnt_pos, chi2, depth_ok, inlier


def bundle_adjust_grid(prob: BAGridProblem, iters1: int = 5,
                       iters2: int = 10) -> BAGridResult:
    """Local/global BA on the dense observation grid, scatter-free."""
    cam_Tcw, pnt_pos, chi2, depth_ok, inlier = _two_phase(
        prob, _grid_lm_iteration, _grid_residuals, prob.g_isig, prob.g_act,
        iters1, iters2)
    return BAGridResult(cam_Tcw=cam_Tcw, pnt_pos=pnt_pos, g_chi2=chi2,
                        g_depth_ok=depth_ok, g_inlier=inlier)


def bundle_adjust(prob: BAProblem, iters1: int = 5, iters2: int = 10,
                  sorted_pnt: bool = False) -> BAResult:
    """Local/global BA on flat observations.  ``sorted_pnt`` is accepted
    for the JAX package's signature; ``index_add_`` needs no sorted ids."""
    del sorted_pnt
    cam_Tcw, pnt_pos, chi2, depth_ok, inlier = _two_phase(
        prob, _lm_iteration, _residuals, prob.obs_inv_sigma2, prob.obs_active,
        iters1, iters2)
    return BAResult(cam_Tcw=cam_Tcw, pnt_pos=pnt_pos, obs_chi2=chi2,
                    obs_depth_ok=depth_ok, obs_inlier=inlier)
