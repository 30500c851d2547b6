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

The engine's body runs over a list of shards in lock-step: each shard
holds its own points and their observations, the cameras and the CG state
are replicated, and a ``reduce`` callable sums a camera-space quantity
over the shards at the six places the JAX engine ``psum``s (``Hcc``,
``bc``, each CG matrix-vector product, the right-hand side, the
preconditioner blocks and the LM costs).  One shard with the identity
reduce is :func:`bundle_adjust_cg`; ``parallel/dist_ba.py`` passes a
device mesh's reduce.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Sequence

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


# sums per-shard partials over the shards; returns the total once per
# shard, each on its shard's device
Reduce = Callable[[List[torch.Tensor]], List[torch.Tensor]]


def _identity(parts: List[torch.Tensor]) -> List[torch.Tensor]:
    """The reduce of a single shard."""
    return parts


def _local_blocks(prob: BAProblem, cam_Tcw, pnt_pos, active, lam, use_huber):
    """One shard's pieces of the damped normal equations:
    (Hcc, bc, Hpp_inv, bp, W, chi2).  ``Hcc`` and ``bc`` are this shard's
    partial sums, undamped; the point blocks are complete, because every
    observation of a point lies on the point's shard."""
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

    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = _inv3x3(Hpp_d)
    W = w[:, None, None] * _btb(Jc, Jp)   # (O, 6, 3)
    return Hcc, bc, Hpp_inv, bp, W, chi2


def _schur_term(prob: BAProblem, Hpp_inv, W, x, n_cam: int):
    """One shard's W Hpp^-1 x: ``x`` (P, 3) per point -> (C, 6)."""
    oc, op = prob.obs_cam.long(), prob.obs_pnt.long()
    return _segment_sum(_bmv(W, _bmv(Hpp_inv, x)[op]), oc, n_cam)


def _make_matvec(probs: Sequence[BAProblem], Hcc_d, Hpp_inv, W, free,
                 reduce: Reduce):
    """S v = Hcc_d v - W Hpp^-1 W^T v over the shards, identity on fixed
    cameras; ``v`` and the result hold one (C, 6) tensor per shard."""
    def matvec(vs):
        parts = []
        for p, Hi, Wi, v, f in zip(probs, Hpp_inv, W, vs, free):
            wt_v = _segment_sum(_btv(Wi, (v * f[:, None])[p.obs_cam.long()]),
                                p.obs_pnt.long(), Hi.shape[0])     # W^T v
            parts.append(_schur_term(p, Hi, Wi, wt_v, v.shape[0]))
        y2 = reduce(parts)      # the per-CG-step collective
        return [(_bmv(Hd, v * f[:, None]) - y) * f[:, None]
                + v * (1.0 - f)[:, None]
                for Hd, v, f, y in zip(Hcc_d, vs, free, y2)]

    return matvec


def _cg_start(b, Minv):
    """CG state (x, r, p, rz, |b|^2) for right-hand side ``b``."""
    z = _bmv(Minv, b)
    return (torch.zeros_like(b), b, z, torch.sum(b * z),
            torch.clamp(torch.sum(b * b), min=1e-30))


def _cg_step(x, r, p, rz, b_norm, Ap, Minv):
    """One preconditioned CG step given ``Ap``; a lane stops moving once
    its residual has fallen 1e-12 below the start (``torch.where``, no
    read-back)."""
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    live = (torch.sum(r * r) / b_norm) > 1e-12     # freeze once converged
    alpha = torch.where(live, rz / torch.clamp(torch.sum(p * Ap), min=1e-30),
                        zero)
    x = x + alpha * p
    r = r - alpha * Ap
    z = _bmv(Minv, r)
    rz_new = torch.sum(r * z)
    beta = torch.where(live, rz_new / torch.clamp(rz, min=1e-30), zero)
    return x, r, z + beta * p, rz_new, b_norm


def _pcg_shards(matvec, b, Minv, iters):
    """Block-Jacobi preconditioned CG over replicated shards: ``b`` and
    ``Minv`` hold one tensor per shard (the same values), ``matvec`` maps
    such a list to such a list.  Each shard's dot products are its own, so
    only the matrix-vector product crosses shards."""
    state = [_cg_start(bs, M) for bs, M in zip(b, Minv)]
    for _ in range(iters):
        Ap = matvec([st[2] for st in state])
        state = [_cg_step(*st, A, M) for st, A, M in zip(state, Ap, Minv)]
    return [st[0] for st in state]


def _lm_iteration_cg(probs, cams, pnts, active, lam, use_huber, cg_iters,
                     reduce: Reduce):
    """One LM iteration over the shards.  ``cams`` and ``lam`` are
    replicated (one entry per shard), ``pnts`` and ``active`` local."""
    n_cam = cams[0].shape[0]
    dt, dev = cams[0].dtype, [c.device for c in cams]
    free = [(~p.cam_fixed).to(dt) for p in probs]
    loc = [_local_blocks(p, c, x, a, lm, use_huber)
           for p, c, x, a, lm in zip(probs, cams, pnts, active, lam)]
    Hcc = reduce([b[0] for b in loc])
    bc = reduce([b[1] for b in loc])
    Hpp_inv, bp, W, chi2 = ([b[i] for b in loc] for i in range(2, 6))
    eye6 = [torch.eye(6, dtype=dt, device=d) for d in dev]
    Hcc_d = [H + lm * H * e6 + 1e-8 * e6 for H, lm, e6 in zip(Hcc, lam, eye6)]
    matvec = _make_matvec(probs, Hcc_d, Hpp_inv, W, free, reduce)

    # rhs = bc - W Hpp^-1 bp, zeroed on fixed cameras
    wb = reduce([_schur_term(p, Hi, Wi, b, n_cam)
                 for p, Hi, Wi, b in zip(probs, Hpp_inv, W, bp)])
    rhs = [(b - y) * f[:, None] for b, y, f in zip(bc, wb, free)]

    # exact 6x6 diagonal blocks of S for the preconditioner
    WHW = reduce([
        _segment_sum(_bmm(_bmm(Wi, Hi[p.obs_pnt.long()]), Wi.transpose(-1, -2)),
                     p.obs_cam.long(), n_cam)
        for p, Hi, Wi in zip(probs, Hpp_inv, W)])
    Minv = [torch.linalg.inv_ex(                 # no status read-back
        (Hd - whw) * f[:, None, None] + e6 * (1.0 - f)[:, None, None]
        + 1e-8 * e6).inverse
        for Hd, whw, f, e6 in zip(Hcc_d, WHW, free, eye6)]

    dc = [-x * f[:, None] for x, f in
          zip(_pcg_shards(matvec, rhs, Minv, cg_iters), free)]

    out_c, out_p, out_l, costs = [], [], [], []
    for p, c, x, a, Hi, b, Wi, ch, d in zip(probs, cams, pnts, active,
                                            Hpp_inv, bp, W, chi2, dc):
        # back-substitute this shard's landmarks
        Wt_dc = _segment_sum(_btv(Wi, d[p.obs_cam.long()]), p.obs_pnt.long(),
                             x.shape[0])
        pnt_new = x - _bmv(Hi, b + Wt_dc) * p.pnt_active[:, None]
        cam_new = torch.where(p.cam_fixed[:, None, None], c, se3.retract(c, d))
        out_c.append(cam_new)
        out_p.append(pnt_new)
        # the current state's cost reuses this iteration's chi2; the
        # candidate takes the Jacobian-free light path
        e2, _, _, _ = _residuals(p, cam_new, pnt_new, light=True)
        c2 = torch.sum(e2 * e2, dim=-1) * p.obs_inv_sigma2
        costs.append(torch.stack([
            torch.sum(_robust_cost(ch, HUBER_DELTA, use_huber) * a),
            torch.sum(_robust_cost(c2, HUBER_DELTA, use_huber) * a)]))
    costs = reduce(costs)
    for s, cost in enumerate(costs):
        improved = cost[1] < cost[0]
        out_c[s] = torch.where(improved, out_c[s], cams[s])
        out_p[s] = torch.where(improved, out_p[s], pnts[s])
        out_l.append(torch.where(improved, lam[s] * 0.5, lam[s] * 5.0))
    return out_c, out_p, out_l


def _gate(prob: BAProblem, cam_Tcw, pnt_pos):
    e, _, _, z = _residuals(prob, cam_Tcw, pnt_pos, light=True)
    return torch.sum(e * e, dim=-1) * prob.obs_inv_sigma2, z


def _two_phase_shards(probs: Sequence[BAProblem], step, iters1: int,
                      iters2: int) -> List[BAResult]:
    """The two-phase Huber / gating schedule (Optimizer.py:318-353) over
    shards in lock-step, around an LM ``step(probs, cams, pnts, active,
    lam, use_huber) -> (cams, pnts, lam)``.  Returns one result per shard:
    the cameras replicated, points and observations the shard's own."""
    active = [p.obs_active.to(p.pnt_pos.dtype) for p in probs]

    def phase(cams, pnts, iters, use_huber, act):
        # a Python float: a 0-dim tensor made from the host here would be
        # an upload that waits for the work queued before it
        lam = [1e-4] * len(probs)
        for _ in range(iters):
            cams, pnts, lam = step(probs, cams, pnts, act, lam, use_huber)
        return cams, pnts

    cams, pnts = phase([p.cam_Tcw for p in probs], [p.pnt_pos for p in probs],
                       iters1, True, active)
    gates = [_gate(p, c, x) for p, c, x in zip(probs, cams, pnts)]
    active2 = [a * ((chi2 <= CHI2_STEREO) & (z > 0)).to(a.dtype)
               for a, (chi2, z) in zip(active, gates)]
    cams, pnts = phase(cams, pnts, iters2, False, active2)
    out = []
    for p, c, x in zip(probs, cams, pnts):
        chi2, z = _gate(p, c, x)
        depth_ok = z > 0
        out.append(BAResult(
            cam_Tcw=c, pnt_pos=x, obs_chi2=chi2, obs_depth_ok=depth_ok,
            obs_inlier=p.obs_active & (chi2 <= CHI2_STEREO) & depth_ok))
    return out


def _bundle_adjust_cg_core(probs: Sequence[BAProblem], iters1: int,
                           iters2: int, cg_iters: int,
                           reduce: Reduce = _identity) -> List[BAResult]:
    """The CG engine over shards in lock-step (one result per shard)."""
    step = functools.partial(_lm_iteration_cg, cg_iters=cg_iters,
                             reduce=reduce)
    return _two_phase_shards(probs, step, iters1, iters2)


def bundle_adjust_cg(prob: BAProblem, iters1: int = 5, iters2: int = 10,
                     cg_iters: int = 64) -> BAResult:
    """Drop-in replacement for :func:`ba.bundle_adjust` at global scale:
    the same two-phase Huber / gating schedule (Optimizer.py:318-353),
    inexact LM steps by preconditioned CG on the implicit Schur
    complement."""
    return _bundle_adjust_cg_core([prob], iters1, iters2, cg_iters)[0]
