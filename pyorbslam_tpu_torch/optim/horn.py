"""Closed-form Horn alignment + parallel Sim3 RANSAC.

Port of ``pyorbslam_tpu/optim/horn.py``.  Replaces Sim3Solver.py: Horn's
closed-form Sim3 from 3-point minimal sets (compute_sim3:160-209) inside
RANSAC (iterate:100-158) with bidirectional reprojection gating at
9.21 * sigma^2 (check_inliers:211-227).  All hypotheses are one batch and
the inlier count is one batched reduction.

The JAX package draws its minimal sets with ``jax.random.categorical``;
those bits cannot be had from a ``torch.Generator``.  So
:func:`sim3_ransac_sets` scores given index sets and
:func:`sim3_ransac` draws them from a generator, as ``optim/epnp.py``
does: a test hands both packages the same sets.

For stereo SLAM the scale is fixed at 1 (bFixScale semantics); the
``with_scale`` path implements Horn's symmetric scale for mono parity.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

N_REFINE = 32   # refinement draws among the best hypothesis' inliers


def horn_align(P: torch.Tensor, Q: torch.Tensor, with_scale: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form (R, t, s) minimizing ||Q - (s R P + t)||^2 for point
    sets (..., n, 3), batched over any leading axes (SVD form, equivalent
    to the reference's N-matrix eigenvector method)."""
    mp = P.mean(dim=-2)
    mq = Q.mean(dim=-2)
    Pc = P - mp[..., None, :]
    Qc = Q - mq[..., None, :]
    H = Pc.transpose(-1, -2) @ Qc
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    S = torch.ones(H.shape[:-2] + (3,), dtype=H.dtype, device=H.device)
    S = torch.cat([S[..., :2], d[..., None]], dim=-1)
    R = (V * S[..., None, :]) @ U.transpose(-1, -2)
    if with_scale:
        # Horn's symmetric scale: s = sqrt(sum|Qc|^2 / sum|Pc|^2)
        s = torch.sqrt(torch.sum(Qc * Qc, dim=(-1, -2))
                       / torch.clamp(torch.sum(Pc * Pc, dim=(-1, -2)), min=1e-12))
    else:
        s = torch.ones(H.shape[:-2], dtype=H.dtype, device=H.device)
    t = mq - s[..., None] * torch.einsum("...ij,...j->...i", R, mp)
    return R, t, s


class Sim3RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # () int
    ok: torch.Tensor          # () bool


def _inliers_of(R, t, s, X1, X2, uv1, uv2, sigma2_1, sigma2_2, active, cam4,
                chi2_th):
    """Bidirectional reprojection gate of hypotheses (..., 3, 3), (..., 3),
    (...,) -> (..., N) bool."""
    X2in1 = s[..., None, None] * (X2 @ R.transpose(-1, -2)) + t[..., None, :]
    X1in2 = ((X1 - t[..., None, :]) @ R) / torch.clamp(s, min=1e-9)[..., None, None]

    def proj_err(P, uv):
        z = P[..., 2]
        z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        u = cam4[0] * P[..., 0] / z + cam4[2]
        v = cam4[1] * P[..., 1] / z + cam4[3]
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    e1 = proj_err(X2in1, uv1) / sigma2_1
    e2 = proj_err(X1in2, uv2) / sigma2_2
    return (e1 < chi2_th) & (e2 < chi2_th) & active


def sim3_ransac_sets(
    X1: torch.Tensor,         # (N, 3) camera-1-frame points
    X2: torch.Tensor,         # (N, 3) matched camera-2-frame points
    uv1: torch.Tensor,        # (N, 2) observations in image 1
    uv2: torch.Tensor,        # (N, 2) observations in image 2
    sigma2_1: torch.Tensor,   # (N,) levelSigma2 of kp1
    sigma2_2: torch.Tensor,   # (N,)
    active: torch.Tensor,     # (N,) bool
    cam4: torch.Tensor,       # [fx, fy, cx, cy]
    idx: torch.Tensor,        # (H, 3) minimal sets, indices into N
    refine_idx: Callable[[torch.Tensor], torch.Tensor],
    with_scale: bool = False,
    chi2_th: float = 9.21,    # th1/th2 = 9.21 * sigma^2 (Sim3Solver.py:56-57)
    min_inliers: int = 20,
) -> Sim3RansacResult:
    """S12 such that X1 ~ s R X2 + t from given minimal sets.
    ``refine_idx`` maps the best hypothesis' (N,) inlier mask to the
    indices Horn is re-run on.  Of hypotheses with equal inlier counts
    the first wins (``jnp.argmax``'s rule, made explicit)."""
    idx = idx.long()
    Rs, ts, ss = horn_align(X2[idx], X1[idx], with_scale)      # (H, ...)
    inl = _inliers_of(Rs, ts, ss, X1, X2, uv1, uv2, sigma2_1, sigma2_2,
                      active, cam4, chi2_th)                   # (H, N)
    counts = inl.sum(dim=1)
    H = counts.shape[0]
    order = torch.arange(H - 1, -1, -1, device=counts.device)
    best = torch.argmax(counts * H + order)
    best_inl = inl[best]

    # refine on the best inlier set (resampled Horn over inliers)
    ridx = refine_idx(best_inl).long()
    R_r, t_r, s_r = horn_align(X2[ridx], X1[ridx], with_scale)
    inl_r = _inliers_of(R_r, t_r, s_r, X1, X2, uv1, uv2, sigma2_1, sigma2_2,
                        active, cam4, chi2_th)
    use_r = inl_r.sum() >= counts[best]
    R = torch.where(use_r, R_r, Rs[best])
    t = torch.where(use_r, t_r, ts[best])
    s = torch.where(use_r, s_r, ss[best])
    inliers = torch.where(use_r, inl_r, best_inl)
    n_in = inliers.sum()
    return Sim3RansacResult(R=R, t=t, s=s, inliers=inliers,
                            n_inliers=n_in, ok=n_in >= min_inliers)


def sim3_ransac(
    X1, X2, uv1, uv2, sigma2_1, sigma2_2, active, cam4,
    generator: torch.Generator,   # on the tensors' device
    n_hyp: int = 256, with_scale: bool = False, chi2_th: float = 9.21,
    min_inliers: int = 20,
) -> Sim3RansacResult:
    """:func:`sim3_ransac_sets` with the minimal sets drawn among the
    active correspondences and the refinement set among the best inliers,
    both with replacement, from ``generator``."""

    def draw(mask: torch.Tensor, count: int) -> torch.Tensor:
        return torch.multinomial(mask.to(torch.float32) + 1e-9, count,
                                 replacement=True, generator=generator)

    idx = draw(active, n_hyp * 3).reshape(n_hyp, 3)
    return sim3_ransac_sets(
        X1, X2, uv1, uv2, sigma2_1, sigma2_2, active, cam4, idx,
        lambda inl: draw(inl, N_REFINE), with_scale=with_scale,
        chi2_th=chi2_th, min_inliers=min_inliers)
