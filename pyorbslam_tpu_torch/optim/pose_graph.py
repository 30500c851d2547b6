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
  (``ba_cg._pcg_shards``), O(E + C) memory; its body also runs over edge
  shards, which is ``parallel/dist_pose_graph.py``.

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
from pyorbslam_tpu_torch.optim.ba_cg import _identity, _pcg_shards, _segment_sum


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


def _retract_free(state: Sim3, dx, fixed) -> Sim3:
    """The LM candidate: ``state`` moved by ``dx``, fixed vertices kept."""
    new_state = sim3_mod.retract(state, dx)
    return Sim3(
        R=torch.where(fixed[:, None, None], state.R, new_state.R),
        t=torch.where(fixed[:, None], state.t, new_state.t),
        s=torch.where(fixed, state.s, new_state.s),
    )


def _choose(better, new_state: Sim3, state: Sim3, lam):
    """LM accept / reject on the device."""
    state = Sim3(*(torch.where(better, a, c) for a, c in zip(new_state, state)))
    return state, torch.where(better, lam * 0.5, lam * 5.0)


def _accept_step(state, dx, fixed, e_i, e_j, meas, w, lam):
    new_state = _retract_free(state, dx, fixed)
    better = (_total_err(new_state, e_i, e_j, meas, w)
              < _total_err(state, e_i, e_j, meas, w))
    return _choose(better, new_state, state, lam)


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


def _pose_graph_cg_shards(states, fixed, edges, iters: int, fix_scale: bool,
                         cg_iters: int, reduce):
    """The CG solver over edge shards in lock-step.  ``states`` (Sim3) and
    ``fixed`` hold the replicated vertices, one entry per shard; ``edges``
    holds each shard's (e_i, e_j, measurement Sim3, weight).  ``reduce``
    sums a vertex-space quantity over the shards (``ba_cg.Reduce``): once
    for ``b`` and ``D`` per LM step, once in each CG matrix-vector product
    and once for the two costs.  Returns the states, one per shard."""
    C = states[0].t.shape[0]
    dt = states[0].t.dtype
    free = [_free_mask(f, fix_scale) for f in fixed]
    eye7 = [torch.eye(7, dtype=dt, device=f.device) for f in fixed]
    lam = [1e-8] * len(states)
    for _ in range(iters):
        blocks = [_normal_blocks(*_residual_and_jac(st, e_i, e_j, meas), w)
                  for st, (e_i, e_j, meas, w) in zip(states, edges)]
        b = reduce([_segment_sum(b_i, e_i, C) + _segment_sum(b_j, e_j, C)
                    for (_, _, _, b_i, b_j), (e_i, e_j, _, _) in zip(blocks, edges)])
        # block diagonal of H (masked), shared by damping and preconditioner
        D = reduce([_segment_sum(A_ii, e_i, C) + _segment_sum(A_jj, e_j, C)
                    for (A_ii, A_jj, _, _, _), (e_i, e_j, _, _) in zip(blocks, edges)])
        bf = [bs * f for bs, f in zip(b, free)]
        D = [Ds * f[:, :, None] * f[:, None, :] for Ds, f in zip(D, free)]
        diag = [torch.diagonal(Ds, dim1=1, dim2=2) for Ds in D]   # (C, 7)

        def matvec(vs, _lam=lam, _diag=diag, _blocks=blocks):
            parts = []
            for v, f, (A_ii, A_jj, A_ij, _, _), (e_i, e_j, _, _) in zip(
                    vs, free, _blocks, edges):
                vf = v * f
                yi = _bmv(A_ii, vf[e_i]) + _bmv(A_ij, vf[e_j])
                yj = _bmv(A_ij.transpose(-1, -2), vf[e_i]) + _bmv(A_jj, vf[e_j])
                parts.append(_segment_sum(yi, e_i, C) + _segment_sum(yj, e_j, C))
            # damping / identity terms match the dense solver exactly
            return [y * f + (1.0 - f) * v + lm * dg * (v * f) + 1e-8 * v
                    for y, v, f, lm, dg in zip(reduce(parts), vs, free, _lam, _diag)]

        Minv = [torch.linalg.inv_ex(
            Ds + lm * dg[:, :, None] * e7 + 1e-8 * e7
            + e7 * (1.0 - f)[:, :, None]).inverse
            for Ds, lm, dg, e7, f in zip(D, lam, diag, eye7, free)]
        dx = _pcg_shards(matvec, bf, Minv, cg_iters)
        new = [_retract_free(st, -d, fx) for st, d, fx in zip(states, dx, fixed)]
        errs = reduce([torch.stack([_total_err(n, e_i, e_j, meas, w),
                                    _total_err(st, e_i, e_j, meas, w)])
                       for n, st, (e_i, e_j, meas, w) in zip(new, states, edges)])
        states, lam = map(list, zip(*(
            _choose(err[0] < err[1], n, st, lm)
            for err, n, st, lm in zip(errs, new, states, lam))))
    return states


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
    edges = (e_i.long(), e_j.long(), Sim3(R=m_R, t=m_t, s=m_s),
             e_active.to(t.dtype))
    state, = _pose_graph_cg_shards([Sim3(R=R, t=t, s=s)], [fixed], [edges],
                                   iters, fix_scale, cg_iters, _identity)
    return PoseGraphResult(R=state.R, t=state.t, s=state.s)
