"""Motion-only pose optimization: batched Levenberg-Marquardt on SE(3).

Port of ``pyorbslam_tpu/optim/pose_opt.py`` (reference:
Optimizer.pose_optimization, Optimizer.py:123-208): unary stereo
projection edges with per-octave information, Huber kernel (delta =
sqrt(7.815)), 4 rounds x 10 LM iterations, a chi2 gate of 7.815 per
round with outlier re-admission, no robust kernel in the last round,
and each round restarting from the initial pose with the refined inlier
set.  The residual and Jacobian follow g2o's
``EdgeStereoSE3ProjectXYZOnlyPose`` with the left-multiplicative update
of ``VertexSE3Expmap``.

Every decision stays on the device (``torch.where``, ``solve_ex``
without error checks), so an optimization reads nothing back to the
host.  Inactive slots carry zero weight.

:func:`pose_optimization` runs the whole call as one launch of the CUDA
kernel ``csrc/pose_opt.cu`` for CUDA tensors (``ops/kernels.py``), and
its plain twin :func:`pose_optimization_ref`, the eager loop below, for
CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.geometry import se3
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.utils import trace

CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor          # (4, 4) optimized pose
    inliers: torch.Tensor      # (N,) bool final inlier mask
    num_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor         # (N,) final per-edge chi2 (unweighted)


def _bmm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched (..., i, j) @ (..., j, k) as broadcast-multiply-sum (the
    JAX package's ``optim/ba.py::_bmm``; the inner dims are 3)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _camera_points(Tcw, Xw, obs, cam):
    """Camera-frame points and stereo residuals e = obs - (u, v, ur)."""
    fx, fy, cx, cy, bf = cam[0], cam[1], cam[2], cam[3], cam[4]
    Pc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
    x, y, z = Pc[:, 0], Pc[:, 1], Pc[:, 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    invz = 1.0 / z
    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bf * invz
    e = obs - torch.stack([u, v, ur], dim=-1)
    return Pc, x, y, invz, e


def stereo_residual(
    Tcw: torch.Tensor, Xw: torch.Tensor, obs: torch.Tensor, cam: torch.Tensor
) -> torch.Tensor:
    """Residuals (N, 3) alone: the same arithmetic as
    :func:`stereo_residual_jacobian` without the Jacobian, for the cost
    evaluations that only need e (eager PyTorch does not drop unused
    work as XLA does)."""
    return _camera_points(Tcw, Xw, obs, cam)[-1]


def stereo_residual_jacobian(
    Tcw: torch.Tensor, Xw: torch.Tensor, obs: torch.Tensor, cam: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Residuals (N, 3) and Jacobians (N, 3, 6) wrt xi = (omega, upsilon).

    cam = [fx, fy, cx, cy, bf].
    """
    fx, fy, bf = cam[0], cam[1], cam[4]
    Pc, x, y, invz, e = _camera_points(Tcw, Xw, obs, cam)
    invz2 = invz * invz

    # dh/dPc rows for (u, v, ur)
    zeros = torch.zeros_like(x)
    du = torch.stack([fx * invz, zeros, -fx * x * invz2], dim=-1)
    dv = torch.stack([zeros, fy * invz, -fy * y * invz2], dim=-1)
    dur = du + torch.stack([zeros, zeros, bf * invz2], dim=-1)
    dh_dp = torch.stack([du, dv, dur], dim=1)  # (N, 3, 3)

    # dPc/dxi with left-multiplicative update: dPc = -[Pc]x w + up
    eye = torch.eye(3, dtype=Pc.dtype, device=Pc.device).expand(Pc.shape[:-1] + (3, 3))
    dp_dxi = torch.cat([-se3.hat(Pc), eye], dim=-1)  # (N, 3, 6)
    J = -_bmm(dh_dp, dp_dxi)
    return e, J


def _chi2(e: torch.Tensor, inv_sigma2: torch.Tensor) -> torch.Tensor:
    return torch.sum(e * e, dim=-1) * inv_sigma2


def _huber_weight(chi2: torch.Tensor, delta: float) -> torch.Tensor:
    """g2o RobustKernelHuber weight: 1 inside delta^2, delta/sqrt(chi2) outside."""
    sqrt_chi = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= delta * delta, torch.ones_like(chi2), delta / sqrt_chi)


def _lm_rounds(
    Tcw0, Xw, obs, inv_sigma2, active, cam, iters, use_huber, delta,
):
    """One reference 'round': ``iters`` LM iterations from Tcw0 over the
    currently-active edge set.  Returns the optimized pose."""

    def total(c):
        if use_huber:
            # Huber cost: chi2 inside, 2 delta sqrt(chi2) - delta^2 outside
            s = torch.sqrt(torch.clamp(c, min=1e-12))
            rho = torch.where(c <= delta * delta, c, 2 * delta * s - delta * delta)
        else:
            rho = c
        return torch.sum(rho * active)

    eye6 = torch.eye(6, dtype=Tcw0.dtype, device=Tcw0.device)
    T = Tcw0
    lam = torch.full((), 1e-4, dtype=torch.float32, device=Tcw0.device)
    for _ in range(iters):
        e, J = stereo_residual_jacobian(T, Xw, obs, cam)
        chi2 = _chi2(e, inv_sigma2)
        w = _huber_weight(chi2, delta) if use_huber else torch.ones_like(chi2)
        w = w * inv_sigma2 * active
        H = torch.einsum("nij,n,nik->jk", J, w, J)
        b = torch.einsum("nij,n,ni->j", J, w, e)
        # g2o convention: H dx = -b with b = J^T W e; J carries the minus
        # sign of e = obs - h, so dx = -solve(H, b)
        D = torch.diag(torch.diag(H))
        dx = -torch.linalg.solve_ex(H + lam * D + 1e-9 * eye6, b[:, None])[0][:, 0]
        T_new = se3.retract(T, dx)
        e_new = stereo_residual(T_new, Xw, obs, cam)
        chi2_new = _chi2(e_new, inv_sigma2)
        improved = total(chi2_new) < total(chi2)
        T = torch.where(improved, T_new, T)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    return T


def pose_optimization_ref(
    Tcw0: torch.Tensor,        # (4, 4) initial pose
    Xw: torch.Tensor,          # (N, 3) map point world positions
    obs: torch.Tensor,         # (N, 3) measurements (u, v, u_right)
    inv_sigma2: torch.Tensor,  # (N,) per-edge information scale
    active0: torch.Tensor,     # (N,) bool: has map point & stereo obs
    cam: torch.Tensor,         # (5,) [fx, fy, cx, cy, bf]
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """The plain twin of the pose_opt kernel: ``rounds`` x ``iters``
    eager LM iterations (about 180 launches each on a card)."""
    delta = float(np.sqrt(CHI2_STEREO))
    inlier = active0
    T = Tcw0
    for r in range(rounds):
        use_huber = r < 3  # kernel dropped after round index 2 (Optimizer.py:199)
        T = _lm_rounds(
            Tcw0, Xw, obs, inv_sigma2,
            inlier.to(torch.float32), cam, iters, use_huber, delta,
        )
        chi2 = _chi2(stereo_residual(T, Xw, obs, cam), inv_sigma2)
        inlier = active0 & (chi2 <= CHI2_STEREO)

    e = stereo_residual(T, Xw, obs, cam)
    chi2 = _chi2(e, inv_sigma2)
    n_in = torch.sum(inlier.to(torch.int32)).to(torch.int32)
    # with too few correspondences return the initial pose (the reference
    # bails out below 3, Optimizer.py:171)
    enough = torch.sum(active0.to(torch.int32)) >= 3
    T = torch.where(enough, T, Tcw0)
    return PoseOptResult(Tcw=T, inliers=inlier, num_inliers=n_in, chi2=chi2)


@trace.spanned("track.pose_opt")
def pose_optimization(
    Tcw0: torch.Tensor,        # (4, 4) initial pose
    Xw: torch.Tensor,          # (N, 3) map point world positions
    obs: torch.Tensor,         # (N, 3) measurements (u, v, u_right)
    inv_sigma2: torch.Tensor,  # (N,) per-edge information scale
    active0: torch.Tensor,     # (N,) bool: has map point & stereo obs
    cam: torch.Tensor,         # (5,) [fx, fy, cx, cy, bf]
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """Motion-only pose optimization: one launch of the pose_opt kernel for
    CUDA tensors, the twin :func:`pose_optimization_ref` for CPU tensors.
    Inputs: contiguous float32 tensors (``active0`` bool) on one device;
    anything else raises (``kernels.check_pose_inputs``)."""
    dev = kernels.check_pose_inputs(Tcw0, Xw, obs, inv_sigma2, active0, cam,
                                    rounds, iters)
    if dev.type == "cpu":
        return pose_optimization_ref(Tcw0, Xw, obs, inv_sigma2, active0, cam,
                                     rounds, iters)
    return PoseOptResult(*kernels.pose_opt_kernel(
        Tcw0, Xw, obs, inv_sigma2, active0, cam, rounds, iters, CHI2_STEREO))


def synthetic_problem(seed: int, n: int, noise_px: float = 0.3,
                      outlier_frac: float = 0.0, active_frac: float = 1.0,
                      pose_err: float = 0.2, device="cpu") -> tuple:
    """A stereo pose problem for holding the kernel to its twin (the tests,
    ``chip_smoke.py``): N points 4-40 m ahead of a 400 px camera at a random
    pose, Gaussian pixel noise, a share of gross outliers, a share of
    active edges, per-octave weights and a start ``pose_err`` away (the JAX
    package's ``tests/test_pose_opt.py::make_problem``, with numpy's seeded
    draws).  Returns the six inputs of :func:`pose_optimization` on
    ``device``."""
    rng = np.random.default_rng(seed)
    cam = np.array([400.0, 400.0, 320.0, 120.0, 180.0], np.float32)
    Xw = np.stack([rng.uniform(-10, 10, n), rng.uniform(-3, 3, n),
                   rng.uniform(4, 40, n)], 1).astype(np.float32)

    def exp(xi):
        return se3.exp_se3(torch.as_tensor(xi.astype(np.float32))).numpy()

    T_true = exp(np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.5, 3)]))
    Pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
    u = cam[0] * Pc[:, 0] / Pc[:, 2] + cam[2]
    v = cam[1] * Pc[:, 1] / Pc[:, 2] + cam[3]
    obs = np.stack([u, v, u - cam[4] / Pc[:, 2]], 1).astype(np.float32)
    obs += rng.normal(0, noise_px, obs.shape).astype(np.float32)
    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        obs[idx, :2] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
        obs[idx, 2] = obs[idx, 0] - rng.uniform(1, 50, n_out)
    T0 = exp(np.concatenate([rng.normal(0, pose_err * 0.1, 3),
                             rng.normal(0, pose_err, 3)])) @ T_true
    active = rng.random(n) < active_frac
    inv_sigma2 = (1.0 / 1.44 ** rng.integers(0, 8, n)).astype(np.float32)
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=device)
                 for a in (T0.astype(np.float32), Xw, obs, inv_sigma2, active, cam))
