"""Batched EPnP + parallel RANSAC.

Port of ``pyorbslam_tpu/optim/epnp.py``, which replaces PnPsolver.py: the
reference runs EPnP (4 control points, barycentric coordinates, 12x12
eigendecomposition, 3 beta approximations with Gauss-Newton refinement,
PnPsolver.compute_pose:370-411, gauss_newton:537) inside a sequential
adaptive RANSAC loop (iterate:78-174).  Here every minimal set is a row of
a batched solver: H hypotheses of 4 correspondences are solved at once,
inliers are counted with the same per-octave chi2 gate (5.991 * sigma^2,
set_ransac_parameters:43-72), and the best hypothesis is refined by
re-running EPnP on a resample of its inlier set.

Every helper takes leading batch dimensions (the JAX package's ``vmap``
written out).  The least-squares solves go through ``pinv`` (SVD with the
default cutoff, as ``jnp.linalg.lstsq``) and the small inverses and solves
through ``inv_ex`` / ``solve_ex``: a degenerate minimal set (a repeated
index) gives a non-finite hypothesis that counts no inlier, on the CPU and
on CUDA alike, and never raises.

Random draws: :func:`epnp_ransac` samples the minimal sets and the
refinement set from a ``torch.Generator``; :func:`epnp_ransac_sets` takes
the sets themselves, so a test can hand both packages the same ones.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# beta products in the order (b11, b12, b22, b13, b23, b33, b14, b24, b34, b44)
_B10 = ((0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
        (0, 3), (1, 3), (2, 3), (3, 3))
N_REFINE = 64   # correspondences resampled from the best inlier set


def _control_points(Xw: torch.Tensor) -> torch.Tensor:
    """World control points: centroid + scaled PCA axes. (..., n, 3) -> (..., 4, 3)."""
    c0 = Xw.mean(dim=-2)
    centered = Xw - c0[..., None, :]
    cov = centered.transpose(-1, -2) @ centered / Xw.shape[-2]
    eigval, eigvec = torch.linalg.eigh(cov)          # ascending
    # descending order like the reference (largest principal axis first)
    scales = torch.sqrt(torch.clamp(eigval.flip(-1), min=1e-12))
    axes = eigvec.flip(-1).transpose(-1, -2)         # (..., 3, 3) rows = axes
    cws = c0[..., None, :] + scales[..., :, None] * axes
    return torch.cat([c0[..., None, :], cws], dim=-2)


def _barycentric(Xw: torch.Tensor, cw: torch.Tensor) -> torch.Tensor:
    """(..., n, 3), (..., 4, 3) -> alphas (..., n, 4) with rows summing to 1."""
    B = (cw[..., 1:, :] - cw[..., :1, :]).transpose(-1, -2)
    eye = torch.eye(3, dtype=Xw.dtype, device=Xw.device)
    Binv = torch.linalg.inv_ex(B + 1e-12 * eye).inverse
    a123 = (Xw - cw[..., :1, :]) @ Binv.transpose(-1, -2)
    a0 = 1.0 - a123.sum(dim=-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _build_M(alphas: torch.Tensor, uv: torch.Tensor, cam4: torch.Tensor
             ) -> torch.Tensor:
    """(..., n, 4), (..., n, 2) -> M (..., 2n, 12)."""
    fx, fy, cx, cy = cam4[0], cam4[1], cam4[2], cam4[3]
    u = uv[..., 0]
    v = uv[..., 1]
    zero = torch.zeros_like(alphas)
    row_u = torch.stack([alphas * fx, zero, alphas * (cx - u)[..., None]], dim=-1)
    row_v = torch.stack([zero, alphas * fy, alphas * (cy - v)[..., None]], dim=-1)
    M = torch.stack([row_u, row_v], dim=-3)          # (..., n, 2, 4, 3)
    return M.reshape(*alphas.shape[:-2], 2 * alphas.shape[-2], 12)


def _pair_diffs(c: torch.Tensor) -> torch.Tensor:
    """(..., 4, 3) control points -> (..., 6, 3) differences over the pairs."""
    return torch.stack([c[..., a, :] - c[..., b, :] for a, b in _PAIRS], dim=-2)


def _rho(cw: torch.Tensor) -> torch.Tensor:
    """Squared distances between the 6 control-point pairs: (..., 6)."""
    return (_pair_diffs(cw) ** 2).sum(dim=-1)


def _L6x10(V: torch.Tensor) -> torch.Tensor:
    """V: (..., 4, 12) null-space basis (rows) -> L (..., 6, 10) for the
    beta system in the order of ``_B10``."""
    v = V.reshape(*V.shape[:-1], 4, 3)               # (..., basis, ctrl, xyz)
    dv = _pair_diffs(v)                              # (..., basis, 6, 3)
    cols = []
    for i, j in _B10:
        dot = (dv[..., i, :, :] * dv[..., j, :, :]).sum(dim=-1)   # (..., 6)
        cols.append(dot if i == j else 2.0 * dot)
    return torch.stack(cols, dim=-1)


def _lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares through the SVD pseudo-inverse."""
    return (torch.linalg.pinv(A) @ b[..., None])[..., 0]


def _guard(b1: torch.Tensor) -> torch.Tensor:
    return torch.where(b1 < 1e-8, torch.full_like(b1, 1e-8), b1)


def _betas_case1(L, rho):
    """betas_approx_1: unknowns (b11, b12, b13, b14)."""
    x = _lstsq(L[..., [0, 1, 3, 6]], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    g = _guard(b1)
    return torch.stack([b1, x[..., 1] / g, x[..., 2] / g, x[..., 3] / g], dim=-1)


def _betas_case2(L, rho):
    """betas_approx_2: unknowns (b11, b12, b22)."""
    x = _lstsq(L[..., [0, 1, 2]], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    b2 = torch.sqrt(torch.abs(x[..., 2]))
    b2 = torch.where(x[..., 1] < 0, -b2, b2)
    zero = torch.zeros_like(b1)
    return torch.stack([b1, b2, zero, zero], dim=-1)


def _betas_case3(L, rho):
    """betas_approx_3: unknowns (b11, b12, b22, b13, b23)."""
    x = _lstsq(L[..., [0, 1, 2, 3, 4]], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    b2 = torch.sqrt(torch.abs(x[..., 2]))
    b2 = torch.where(x[..., 1] < 0, -b2, b2)
    b3 = x[..., 3] / _guard(b1)
    return torch.stack([b1, b2, b3, torch.zeros_like(b1)], dim=-1)


def _gauss_newton_betas(L, rho, betas, iters: int = 5):
    """Refine betas on ||L b10(beta) - rho|| (PnPsolver.gauss_newton:537).
    The Jacobian of the ten beta products is written out."""
    eye = torch.eye(4, dtype=L.dtype, device=L.device)
    for _ in range(iters):
        b10 = torch.stack([betas[..., i] * betas[..., j] for i, j in _B10], dim=-1)
        r = (L @ b10[..., None])[..., 0] - rho
        # d(b_i b_j)/d b_k = delta_ik b_j + delta_jk b_i
        D = torch.stack([
            eye[i] * betas[..., j, None] + eye[j] * betas[..., i, None]
            for i, j in _B10], dim=-2)               # (..., 10, 4)
        J = L @ D                                    # (..., 6, 4)
        Jt = J.transpose(-1, -2)
        JtJ = Jt @ J + 1e-9 * eye
        step = torch.linalg.solve_ex(JtJ, Jt @ r[..., None]).result[..., 0]
        betas = betas - step
    return betas


def _pose_from_betas(V, betas, alphas, Xw):
    """Camera control points from betas -> Horn alignment world->camera."""
    ccs = (betas[..., None, :] @ V)[..., 0, :]
    ccs = ccs.reshape(*ccs.shape[:-1], 4, 3)         # 4 camera control points
    pcs = alphas @ ccs                               # (..., n, 3)
    # enforce positive depth (EPnP sign ambiguity)
    flip = torch.sign(pcs[..., 2]).sum(dim=-1) < 0
    pcs = torch.where(flip[..., None, None], -pcs, pcs)

    # Horn: closed-form rigid alignment Xw -> pcs
    cw0 = Xw.mean(dim=-2)
    cc0 = pcs.mean(dim=-2)
    H = (Xw - cw0[..., None, :]).transpose(-1, -2) @ (pcs - cc0[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    Vm = Vt.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(Vm @ Ut))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = Vm @ D @ Ut
    t = cc0 - (R @ cw0[..., None])[..., 0]
    return R, t


def _project(R, t, Xw, cam4):
    """Pinhole projection of (..., n, 3) points: u, v, guarded depth."""
    Pc = Xw @ R.transpose(-1, -2) + t[..., None, :]
    z = Pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam4[0] * Pc[..., 0] / z + cam4[2]
    v = cam4[1] * Pc[..., 1] / z + cam4[3]
    return u, v, z


def epnp_single(Xw: torch.Tensor, uv: torch.Tensor, cam4: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """EPnP closed form on one correspondence set, or on a batch of them.

    Xw (..., n, 3), uv (..., n, 2), cam4 = [fx, fy, cx, cy] ->
    (R (..., 3, 3), t (..., 3)).
    """
    cw = _control_points(Xw)
    alphas = _barycentric(Xw, cw)
    M = _build_M(alphas, uv, cam4)
    _, eigvec = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    V = eigvec[..., :, :4].transpose(-1, -2)         # (..., 4, 12) smallest first
    L = _L6x10(V)
    rho = _rho(cw)

    errs, Rs, ts = [], [], []
    for case in (_betas_case1, _betas_case2, _betas_case3):
        betas = _gauss_newton_betas(L, rho, case(L, rho))
        R, t = _pose_from_betas(V, betas, alphas, Xw)
        u, v, _ = _project(R, t, Xw, cam4)
        errs.append(((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2).sum(dim=-1))
        Rs.append(R)
        ts.append(t)
    best = torch.argmin(torch.stack(errs, dim=-1), dim=-1)       # (...,)
    Rs = torch.stack(Rs, dim=-3)                                 # (..., 3, 3, 3)
    ts = torch.stack(ts, dim=-2)                                 # (..., 3, 3)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        *best.shape, 1, 3, 3))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    return R, t


class PnPResult(NamedTuple):
    R: torch.Tensor            # (3, 3)
    t: torch.Tensor            # (3,)
    inliers: torch.Tensor      # (N,) bool
    n_inliers: torch.Tensor    # () int
    ok: torch.Tensor           # () bool


def epnp_ransac_sets(
    Xw: torch.Tensor,          # (N, 3) world points
    uv: torch.Tensor,          # (N, 2) observations
    sigma2: torch.Tensor,      # (N,) per-match sigma^2 (levelSigma2[octave])
    active: torch.Tensor,      # (N,) bool
    cam4: torch.Tensor,        # [fx, fy, cx, cy]
    idx: torch.Tensor,         # (H, 4) minimal sets, indices into N
    refine_idx: Callable[[torch.Tensor], torch.Tensor],
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    """Parallel-hypothesis EPnP RANSAC + inlier-set refinement on given
    minimal sets.  ``refine_idx`` maps the best hypothesis' (N,) bool
    inlier mask to the indices EPnP is re-run on.  Of hypotheses with
    equal inlier counts the first wins."""
    idx = idx.long()
    Rs, ts = epnp_single(Xw[idx], uv[idx], cam4)     # (H, 3, 3), (H, 3)

    def inliers_of(R, t):
        u, v, z = _project(R, t, Xw, cam4)
        err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return (err2 / sigma2 < chi2_th) & (z > 0) & active

    inl = inliers_of(Rs, ts)                         # (H, N)
    counts = inl.sum(dim=1)
    H = counts.shape[0]
    order = torch.arange(H - 1, -1, -1, device=counts.device)
    best = torch.argmax(counts * H + order)
    best_inl = inl[best]

    ridx = refine_idx(best_inl).long()
    R_ref, t_ref = epnp_single(Xw[ridx], uv[ridx], cam4)
    inliers = inliers_of(R_ref, t_ref)
    n_in = inliers.sum()

    # fall back to the raw best hypothesis if refinement regressed
    use_ref = n_in >= counts[best]
    R = torch.where(use_ref, R_ref, Rs[best])
    t = torch.where(use_ref, t_ref, ts[best])
    inliers = torch.where(use_ref, inliers, best_inl)
    n_in = torch.maximum(n_in, counts[best])
    return PnPResult(R=R, t=t, inliers=inliers, n_inliers=n_in,
                     ok=n_in >= min_inliers)


def epnp_ransac(
    Xw: torch.Tensor, uv: torch.Tensor, sigma2: torch.Tensor,
    active: torch.Tensor, cam4: torch.Tensor,
    generator: torch.Generator,    # on the tensors' device
    n_hyp: int = 128,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    """:func:`epnp_ransac_sets` with the minimal sets drawn among the active
    correspondences and the refinement set among the best inliers, both
    with replacement, from ``generator``."""

    def draw(mask: torch.Tensor, count: int) -> torch.Tensor:
        return torch.multinomial(mask.to(torch.float32) + 1e-9, count,
                                 replacement=True, generator=generator)

    idx = draw(active, n_hyp * 4).reshape(n_hyp, 4)
    return epnp_ransac_sets(
        Xw, uv, sigma2, active, cam4, idx, lambda inl: draw(inl, N_REFINE),
        chi2_th=chi2_th, min_inliers=min_inliers)
