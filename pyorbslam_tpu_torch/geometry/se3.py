"""SE(3) Lie-group operations as batched PyTorch functions.

Port of ``pyorbslam_tpu/geometry/se3.py``.  Poses are 4x4 row-major
matrices ``Tcw`` (world -> camera).  The tangent parameterization is
``xi = (omega, upsilon)``, rotation first, matching g2o's
``SE3Quat::exp`` so LM updates reproduce ``VertexSE3Expmap::oplusImpl``
(``exp(xi) * estimate``).  Small-angle branches are ``torch.where`` with
Taylor fallbacks, so no function reads a value back to the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. omega: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(theta2):
    """(A, B, C) = (sin t / t, (1-cos t)/t^2, (1 - A)/t^2) with Taylor
    fallbacks near zero."""
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - A) / theta2)
    return A, B, C


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(omega * omega, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(omega)
    W2 = W @ W
    I = _eye3(omega, W.shape)
    return I + A[..., None, None] * W + B[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3), via atan2 (stable for
    angles below pi - eps)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = 0.5 * torch.sqrt(torch.sum(w * w, dim=-1) + _EPS * _EPS)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-5
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.where(small, torch.ones_like(sin_t), sin_t)),
    )
    return w * scale[..., None]


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exponential. xi = (omega, upsilon): (..., 6) -> (..., 4, 4)."""
    omega, upsilon = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(omega * omega, dim=-1)
    A, B, C = _sinc_coeffs(theta2)
    W = hat(omega)
    W2 = W @ W
    I = _eye3(xi, W.shape)
    R = I + A[..., None, None] * W + B[..., None, None] * W2
    V = I + B[..., None, None] * W + C[..., None, None] * W2
    t = torch.einsum("...ij,...j->...i", V, upsilon)
    return rt_to_mat(R, t)


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) with (omega, upsilon) ordering."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = log_so3(R)
    theta2 = torch.sum(omega * omega, dim=-1)
    _, B, C = _sinc_coeffs(theta2)
    W = hat(omega)
    W2 = W @ W
    I = _eye3(T, W.shape)
    V = I + B[..., None, None] * W + C[..., None, None] * W2
    upsilon = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([omega, upsilon], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3) -> (..., 4, 4)."""
    batch = R.shape[:-2]
    # made on the device: a list would be uploaded, and waited for, per call
    bottom = torch.zeros(batch + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 3] = 1.0
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form SE3 inverse (no linear solve)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., N, 3) or (..., 3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.dim() == T.dim():  # (..., N, 3) against (..., 4, 4)
        return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]
    return torch.einsum("...ij,...j->...i", R, pts) + t


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative update  T <- exp(xi) @ T  (g2o VertexSE3Expmap)."""
    return exp_se3(xi) @ T


def orthonormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) via SVD."""
    u, _, vt = torch.linalg.svd(R)
    det = torch.linalg.det(u @ vt)
    d = torch.ones(R.shape[:-2] + (3,), dtype=R.dtype, device=R.device)
    d[..., 2] = det
    return (u * d[..., None, :]) @ vt


def camera_center(Tcw: torch.Tensor) -> torch.Tensor:
    """World coords of the optical center: Ow = -Rcw^T tcw (Frame.py:135)."""
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", R, t)
