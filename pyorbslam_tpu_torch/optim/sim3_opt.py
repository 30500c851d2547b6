"""Relative Sim3 refinement with bidirectional projection edges.

Port of ``pyorbslam_tpu/optim/sim3_opt.py``.  Replaces
Optimizer.optimize_sim3 (Optimizer.py:368-483): one Sim3 vertex, fixed
3-D points, 2-D projection residuals in both directions
(EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ), Huber delta =
sqrt(th2), 5 iterations, a chi2 gate removing bad pairs, 10 more
iterations, inlier count.  The Jacobian is the forward-mode derivative of
the 7-parameter retraction (``sim3.jacobian``; ``jax.jacfwd`` in the JAX
package).  The LM loop is a Python loop of eager ops whose accept /
reject is a ``torch.where``: nothing is read back inside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyorbslam_tpu_torch.geometry import sim3 as sim3_mod
from pyorbslam_tpu_torch.geometry.sim3 import Sim3


class Sim3OptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _residuals(params: Sim3, X1c, X2c, obs1, obs2, cam4):
    """Bidirectional 2-D reprojection residuals: (M, 2), (M, 2)."""
    X2in1 = sim3_mod.act(params, X2c)
    X1in2 = sim3_mod.act(sim3_mod.inverse(params), X1c)

    def proj(P, obs):
        z = P[..., 2]
        z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
        u = cam4[0] * P[..., 0] / z + cam4[2]
        v = cam4[1] * P[..., 1] / z + cam4[3]
        return obs - torch.stack([u, v], dim=-1)

    return proj(X2in1, obs1), proj(X1in2, obs2)


def optimize_sim3(
    S12_R: torch.Tensor, S12_t: torch.Tensor, S12_s: torch.Tensor,
    X1c: torch.Tensor,        # (M, 3) matched points in camera-1 frame
    X2c: torch.Tensor,        # (M, 3) matched points in camera-2 frame
    obs1: torch.Tensor,       # (M, 2)
    obs2: torch.Tensor,       # (M, 2)
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    active: torch.Tensor,     # (M,) bool
    cam4: torch.Tensor,
    th2: float = 10.0,
    fix_scale: bool = True,
    iters1: int = 5,
    iters2: int = 10,
) -> Sim3OptResult:
    delta = float(th2) ** 0.5
    dt, dev = X1c.dtype, X1c.device
    isig = torch.cat([inv_sigma2_1, inv_sigma2_2])
    eye7 = torch.eye(7, dtype=dt, device=dev)
    keep = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        keep[6] = 0.0

    def chi2_pair(p):
        e1, e2 = _residuals(p, X1c, X2c, obs1, obs2, cam4)
        return (torch.sum(e1 * e1, -1) * inv_sigma2_1,
                torch.sum(e2 * e2, -1) * inv_sigma2_2)

    def total(p, act):
        c1, c2 = chi2_pair(p)
        return torch.sum((c1 + c2) * act)

    def gn_phase(p, act, iters, use_huber):
        lam = 1e-3
        act2 = torch.cat([act, act])
        for _ in range(iters):
            def res_of_xi(xi, _p=p):
                # xi (..., 1, 7): the retracted pose keeps a batch axis of
                # one, which broadcasts against the points (sim3.jacobian)
                pp = sim3_mod.retract(_p, xi * keep)
                e1, e2 = _residuals(pp, X1c, X2c, obs1, obs2, cam4)
                return torch.cat([e1, e2], dim=-2)             # (..., 2M, 2)

            zero = torch.zeros(1, 7, dtype=dt, device=dev)
            e = res_of_xi(zero)
            J = sim3_mod.jacobian(res_of_xi, zero)             # (2M, 2, 7)
            c2 = torch.sum(e * e, -1) * isig
            if use_huber:
                sq = torch.sqrt(torch.clamp(c2, min=1e-12))
                hub = torch.where(c2 <= th2, torch.ones_like(c2), delta / sq)
            else:
                hub = torch.ones_like(c2)
            wgt = hub * isig * act2
            H = torch.einsum("mij,m,mik->jk", J, wgt, J)
            b = torch.einsum("mij,m,mi->j", J, wgt, e)
            if fix_scale:
                H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
                b = b * keep
            A = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
            dx = -torch.linalg.solve_ex(A, b).result * keep
            p_new = sim3_mod.retract(p, dx)
            better = total(p_new, act) < total(p, act)
            p = Sim3(*(torch.where(better, a, b2) for a, b2 in zip(p_new, p)))
            lam = torch.where(better, lam * 0.5, lam * 5.0)
        return p

    params = Sim3(R=S12_R, t=S12_t, s=S12_s)
    act = active.to(dt)
    params = gn_phase(params, act, iters1, True)

    c1, c2 = chi2_pair(params)
    good = (c1 <= th2) & (c2 <= th2) & active
    params = gn_phase(params, good.to(dt), iters2, False)

    c1, c2 = chi2_pair(params)
    inliers = (c1 <= th2) & (c2 <= th2) & active
    return Sim3OptResult(R=params.R, t=params.t, s=params.s,
                         inliers=inliers, n_inliers=inliers.sum())
