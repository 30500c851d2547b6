"""Sim3 pose-graph (essential graph) optimization.

Port of ``pyorbslam_tpu/optim/pose_graph.py``.  Replaces
Optimizer.optimize_essential_graph (Optimizer.py:485-658): Sim3 vertices
for every keyframe, relative-Sim3 edges (loop connections, spanning
tree, previous loop edges, strong covisibles), identity 7x7 information,
20 LM iterations, loop keyframe fixed.

Two interchangeable solvers over the same edge algebra:

* :func:`optimize_pose_graph`: per-edge residuals r = log(Sji * Si * Sj^-1)
  and their forward-mode Jacobians scattered into a dense (7C x 7C)
  normal matrix, one solve per iteration;
* :func:`optimize_pose_graph_cg`: the same damped normal equations solved
  matrix-free with block-Jacobi preconditioned CG over the edge list
  (``ba_cg._pcg``), O(E + C) memory.

Scale components are frozen for stereo (bFixScale).  Each LM iteration's
accept / reject is a ``torch.where`` and the solves are the ``_ex``
variants, which do not read a status flag back: nothing waits for the
device inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pyorbslam_tpu_torch.geometry import sim3 as sim3_mod
from pyorbslam_tpu_torch.geometry.sim3 import Sim3
from pyorbslam_tpu_torch.optim.ba import _bmv
from pyorbslam_tpu_torch.optim.ba_cg import _pcg, _segment_sum


class PoseGraphResult(NamedTuple):
    R: torch.Tensor    # (C, 3, 3) corrected Siw rotations
    t: torch.Tensor    # (C, 3)
    s: torch.Tensor    # (C,)


def _edge_residual(Si: Sim3, Sj: Sim3, Sji: Sim3) -> torch.Tensor:
    """r = log(Sji * Si * Sj^-1): zero iff the relative transform matches
    the measurement (EdgeSim3 semantics)."""
    return sim3_mod.log(
        sim3_mod.compose(Sji, sim3_mod.compose(Si, sim3_mod.inverse(Sj))))


def _gather(state: Sim3, idx: torch.Tensor) -> Sim3:
    return Sim3(*(a[idx] for a in state))


def _residual_and_jac(state: Sim3, e_i, e_j, meas: Sim3):
    """Per-edge residual (E, 7) and Jacobians (E, 7, 7) with respect to the
    two endpoint tangent perturbations, at the current state."""
    Si, Sj = _gather(state, e_i), _gather(state, e_j)
    zero = torch.zeros(e_i.shape[0], 7, dtype=state.t.dtype,
                       device=state.t.device)
    r = _edge_residual(Si, Sj, meas)
    Ji = sim3_mod.jacobian(
        lambda xi: _edge_residual(sim3_mod.retract(Si, xi), Sj, meas), zero)
    Jj = sim3_mod.jacobian(
        lambda xi: _edge_residual(Si, sim3_mod.retract(Sj, xi), meas), zero)
    return r, Ji, Jj


def _total_err(state: Sim3, e_i, e_j, meas: Sim3, w):
    r = _edge_residual(_gather(state, e_i), _gather(state, e_j), meas)
    return torch.sum(torch.sum(r * r, -1) * w)


def _free_mask(fixed, fix_scale: bool):
    free = (~fixed).to(torch.float32)[:, None].repeat(1, 7)
    if fix_scale:
        free[:, 6] = 0.0
    return free   # (C, 7)


def _accept_step(state, dx, fixed, e_i, e_j, meas, w, lam):
    new_state = sim3_mod.retract(state, dx)
    new_state = Sim3(
        R=torch.where(fixed[:, None, None], state.R, new_state.R),
        t=torch.where(fixed[:, None], state.t, new_state.t),
        s=torch.where(fixed, state.s, new_state.s),
    )
    better = (_total_err(new_state, e_i, e_j, meas, w)
              < _total_err(state, e_i, e_j, meas, w))
    state = Sim3(*(torch.where(better, a, c) for a, c in zip(new_state, state)))
    return state, torch.where(better, lam * 0.5, lam * 5.0)


def _normal_blocks(r, Ji, Jj, w):
    wJi = w[:, None, None] * Ji
    wJj = w[:, None, None] * Jj
    A_ii = torch.einsum("eij,eik->ejk", wJi, Ji)
    A_jj = torch.einsum("eij,eik->ejk", wJj, Jj)
    A_ij = torch.einsum("eij,eik->ejk", wJi, Jj)
    b_i = torch.einsum("eij,ei->ej", wJi, r)
    b_j = torch.einsum("eij,ei->ej", wJj, r)
    return A_ii, A_jj, A_ij, b_i, b_j


def optimize_pose_graph(
    R: torch.Tensor,          # (C, 3, 3) initial Siw
    t: torch.Tensor,          # (C, 3)
    s: torch.Tensor,          # (C,)
    fixed: torch.Tensor,      # (C,) bool (loop KF + padding)
    e_i: torch.Tensor,        # (E,) int32 vertex i per edge
    e_j: torch.Tensor,        # (E,) int32 vertex j
    m_R: torch.Tensor,        # (E, 3, 3) measured Sji
    m_t: torch.Tensor,        # (E, 3)
    m_s: torch.Tensor,        # (E,)
    e_active: torch.Tensor,   # (E,) bool
    iters: int = 20,
    fix_scale: bool = True,
) -> PoseGraphResult:
    C = R.shape[0]
    dt, dev = t.dtype, t.device
    e_i, e_j = e_i.long(), e_j.long()
    meas = Sim3(R=m_R, t=m_t, s=m_s)
    free_f = _free_mask(fixed, fix_scale).reshape(-1)
    w = e_active.to(dt)
    eye = torch.eye(7 * C, dtype=dt, device=dev)
    state, lam = Sim3(R=R, t=t, s=s), 1e-8
    for _ in range(iters):
        r, Ji, Jj = _residual_and_jac(state, e_i, e_j, meas)
        A_ii, A_jj, A_ij, b_i, b_j = _normal_blocks(r, Ji, Jj, w)
        H = torch.zeros((C, C, 7, 7), dtype=dt, device=dev)
        H.index_put_((e_i, e_i), A_ii, accumulate=True)
        H.index_put_((e_j, e_j), A_jj, accumulate=True)
        H.index_put_((e_i, e_j), A_ij, accumulate=True)
        H.index_put_((e_j, e_i), A_ij.transpose(-1, -2), accumulate=True)
        b = _segment_sum(b_i, e_i, C) + _segment_sum(b_j, e_j, C)

        Hf = H.permute(0, 2, 1, 3).reshape(7 * C, 7 * C)
        Hf = Hf * free_f[:, None] * free_f[None, :]
        Hf = (Hf + torch.diag(1.0 - free_f)
              + lam * torch.diag(torch.diagonal(Hf)) + 1e-8 * eye)
        bf = b.reshape(-1) * free_f
        dx = -torch.linalg.solve_ex(Hf, bf).result.reshape(C, 7)
        state, lam = _accept_step(state, dx, fixed, e_i, e_j, meas, w, lam)
    return PoseGraphResult(R=state.R, t=state.t, s=state.s)


def optimize_pose_graph_cg(
    R: torch.Tensor, t: torch.Tensor, s: torch.Tensor, fixed: torch.Tensor,
    e_i: torch.Tensor, e_j: torch.Tensor,
    m_R: torch.Tensor, m_t: torch.Tensor, m_s: torch.Tensor,
    e_active: torch.Tensor,
    iters: int = 20, fix_scale: bool = True, cg_iters: int = 96,
) -> PoseGraphResult:
    """Matrix-free variant of :func:`optimize_pose_graph` (same arguments,
    same damping and acceptance), solving each LM step by block-Jacobi
    preconditioned CG over the edge list."""
    C = R.shape[0]
    dt, dev = t.dtype, t.device
    e_i, e_j = e_i.long(), e_j.long()
    meas = Sim3(R=m_R, t=m_t, s=m_s)
    free = _free_mask(fixed, fix_scale)
    w = e_active.to(dt)
    eye7 = torch.eye(7, dtype=dt, device=dev)
    state, lam = Sim3(R=R, t=t, s=s), 1e-8
    for _ in range(iters):
        r, Ji, Jj = _residual_and_jac(state, e_i, e_j, meas)
        A_ii, A_jj, A_ij, b_i, b_j = _normal_blocks(r, Ji, Jj, w)
        bf = (_segment_sum(b_i, e_i, C) + _segment_sum(b_j, e_j, C)) * free

        # block diagonal of H (masked), shared by damping and preconditioner
        D = _segment_sum(A_ii, e_i, C) + _segment_sum(A_jj, e_j, C)
        D = D * free[:, :, None] * free[:, None, :]
        diag = torch.diagonal(D, dim1=1, dim2=2)           # (C, 7) masked

        def matvec(v, _lam=lam, _diag=diag):
            vf = v * free
            yi = _bmv(A_ii, vf[e_i]) + _bmv(A_ij, vf[e_j])
            yj = _bmv(A_ij.transpose(-1, -2), vf[e_i]) + _bmv(A_jj, vf[e_j])
            y = (_segment_sum(yi, e_i, C) + _segment_sum(yj, e_j, C)) * free
            # damping / identity terms match the dense solver exactly
            return y + (1.0 - free) * v + _lam * _diag * vf + 1e-8 * v

        Dd = (D + lam * diag[:, :, None] * eye7 + 1e-8 * eye7
              + eye7 * (1.0 - free)[:, :, None])
        Minv = torch.linalg.inv_ex(Dd).inverse
        dx = -_pcg(matvec, bf, Minv, cg_iters)
        state, lam = _accept_step(state, dx, fixed, e_i, e_j, meas, w, lam)
    return PoseGraphResult(R=state.R, t=state.t, s=state.s)
