"""Sim(3) Lie-group operations as batched PyTorch functions.

Port of ``pyorbslam_tpu/geometry/sim3.py``.  A similarity transform is
the triple ``(R, t, s)`` with ``x' = s * R @ x + t``, the group the
reference manipulates through ``g2o.Sim3`` (sim3.h:42-86);
:func:`to_matrix` folds s into R as Converter.py:27-39 does.

The tangent ordering is ``(omega, upsilon, sigma)`` (rotation,
translation, log-scale).  Exp / log use the closed-form W-matrix
coefficients of Strasdat's Sim3 formulation with Taylor fallbacks as
``torch.where`` branches, so every function is differentiable in forward
mode (``torch.func.jvp``) and reads nothing back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyorbslam_tpu_torch.geometry import se3

_EPS = 1e-7


class Sim3(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    s: torch.Tensor  # (...,)

    @staticmethod
    def identity(batch=(), dtype=torch.float32, device=None) -> "Sim3":
        return Sim3(
            R=torch.eye(3, dtype=dtype, device=device).expand(
                tuple(batch) + (3, 3)),
            t=torch.zeros(tuple(batch) + (3,), dtype=dtype, device=device),
            s=torch.ones(tuple(batch), dtype=dtype, device=device),
        )

    @staticmethod
    def from_se3(T: torch.Tensor) -> "Sim3":
        return Sim3(R=T[..., :3, :3], t=T[..., :3, 3],
                    s=torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device))


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", A, x)


def compose(a: Sim3, b: Sim3) -> Sim3:
    """a * b (apply b first)."""
    return Sim3(R=a.R @ b.R, t=a.s[..., None] * _mv(a.R, b.t) + a.t,
                s=a.s * b.s)


def inverse(g: Sim3) -> Sim3:
    Rt = g.R.transpose(-1, -2)
    inv_s = 1.0 / g.s
    return Sim3(R=Rt, t=-inv_s[..., None] * _mv(Rt, g.t), s=inv_s)


def act(g: Sim3, pts: torch.Tensor) -> torch.Tensor:
    """Apply to points (..., N, 3) or (..., 3)."""
    if pts.dim() == g.R.dim():
        return g.s[..., None, None] * torch.einsum(
            "...ij,...nj->...ni", g.R, pts) + g.t[..., None, :]
    return g.s[..., None] * _mv(g.R, pts) + g.t


def to_matrix(g: Sim3) -> torch.Tensor:
    """4x4 with the scale folded into the rotation block."""
    return se3.rt_to_mat(g.s[..., None, None] * g.R, g.t)


def _w_coeffs(theta2, sigma):
    """Closed-form coefficients (A, B, C) of W = A*Wx + B*Wx^2 + C*I."""
    one = torch.ones_like(sigma)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    sig2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta2 < 1e-8

    # C = (s - 1)/sigma, -> 1 + sigma/2 as sigma -> 0
    C = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                    (s - 1.0) / torch.where(small_sig, one, sigma))

    # sigma ~ 0 branch
    A0 = torch.where(small_th, 0.5 - theta2 / 24.0,
                     (1.0 - torch.cos(theta)) / theta2)
    B0 = torch.where(small_th, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - torch.sin(theta)) / (theta2 * theta))

    # sigma != 0, theta ~ 0 branch
    safe_sig = torch.where(small_sig, one, sigma)
    A1 = ((sigma - 1.0) * s + 1.0) / (safe_sig * safe_sig)
    B1 = ((0.5 * sig2 - sigma + 1.0) * s - 1.0) / (safe_sig ** 3)

    # general branch
    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    c = theta2 + sig2
    safe_c = torch.where(c < _EPS, torch.ones_like(c), c)
    A2 = (a * sigma + (1.0 - b) * theta) / (theta * safe_c)
    B2 = (C - ((b - 1.0) * sigma + a * theta) / safe_c) / theta2

    A = torch.where(small_sig, A0, torch.where(small_th, A1, A2))
    B = torch.where(small_sig, B0, torch.where(small_th, B1, B2))
    return A, B, C


def _w_matrix(omega, sigma):
    theta2 = torch.sum(omega * omega, dim=-1)
    A, B, C = _w_coeffs(theta2, sigma)
    Wx = se3.hat(omega)
    I = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(Wx.shape)
    return (A[..., None, None] * Wx + B[..., None, None] * (Wx @ Wx)
            + C[..., None, None] * I)


def exp(xi: torch.Tensor) -> Sim3:
    """(..., 7) tangent (omega, upsilon, sigma) -> Sim3."""
    omega, upsilon, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _w_matrix(omega, sigma)
    return Sim3(R=se3.exp_so3(omega), t=_mv(W, upsilon), s=torch.exp(sigma))


def log(g: Sim3) -> torch.Tensor:
    """Sim3 -> (..., 7) tangent (omega, upsilon, sigma)."""
    omega = se3.log_so3(g.R)
    sigma = torch.log(g.s)
    W = _w_matrix(omega, sigma)
    upsilon = torch.linalg.solve_ex(W, g.t[..., None]).result[..., 0]
    return torch.cat([omega, upsilon, sigma[..., None]], dim=-1)


def retract(g: Sim3, xi: torch.Tensor) -> Sim3:
    """Left-multiplicative update g <- exp(xi) * g (g2o VertexSim3Expmap)."""
    return compose(exp(xi), g)


def jacobian(fn, xi0: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of ``fn`` at ``xi0`` (B, 7) -> fn's output
    shape + (7,) (the JAX package's vmapped ``jax.jacfwd``): ONE
    ``torch.func.jvp`` with the 7 tangent directions stacked on a new
    leading axis, which ``fn`` must broadcast over (every function of this
    module does), so the residual's ops run once for all seven columns.
    ``xi0`` keeps its batch axis even for one tangent: in forward mode a
    0-dim float32 tensor combined with a Python float yields a float64
    tangent, which the next float32 product refuses."""
    k = xi0.shape[-1]
    eye = torch.eye(k, dtype=xi0.dtype, device=xi0.device)
    shape = (k,) + tuple(xi0.shape)
    tangents = eye.reshape((k,) + (1,) * (xi0.dim() - 1) + (k,)).expand(
        shape).contiguous()
    _, cols = torch.func.jvp(fn, (xi0.expand(shape).contiguous(),),
                             (tangents,))
    return cols.movedim(0, -1)
