"""Distributed Schur bundle adjustment over a device mesh.

Port of ``pyorbslam_tpu/parallel/dist_ba.py``.  Landmarks and their
observations are partitioned across shards so each point's whole
observation set lives on its owner shard; the cameras are replicated.
One LM iteration is then:

  * per shard: residuals and Jacobians of the local observations, the
    local 3x3 landmark blocks inverted in place, the local contribution
    to the reduced camera system S = Hcc - W Hpp^-1 W^T and its rhs;
  * a sum of the camera-space pieces over the shards (:meth:`Mesh.reduce`,
    the JAX package's ``psum``): the only communication;
  * a replicated camera update, then local landmark back-substitution.

:func:`distributed_bundle_adjust` forms the dense (6C x 6C) reduced
system, right for C up to ~128; :func:`distributed_bundle_adjust_cg` is
the implicit-Schur CG engine of ``optim/ba_cg.py`` with one (C, 6) reduce
per CG step, the global-BA engine.

A :class:`Mesh` is this process's shards (a list of devices; a device may
hold several shards) plus an optional ``torch.distributed`` process group
whose ranks hold as many shards each.  Shards run in lock-step in one
Python loop; every decision is a ``torch.where`` on reduced, replicated
values, so every shard and every rank takes the same branch.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pyorbslam_tpu_torch.geometry import se3
from pyorbslam_tpu_torch.optim import ba_cg
from pyorbslam_tpu_torch.optim.ba import (
    HUBER_DELTA,
    BAProblem,
    _accept,
    _bmm,
    _bmv,
    _btv,
    _residuals,
    _robust_cost,
    _solve_reduced,
)
from pyorbslam_tpu_torch.optim.ba_cg import _segment_sum


class Mesh:
    """This process's shards, ``devices`` (one entry per shard), and the
    process group that joins the processes of a multi-process mesh.
    Shard ``i`` of rank ``r`` is global shard ``r * len(devices) + i``."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one shard")
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)

    @property
    def n_shards(self) -> int:
        return len(self.devices) * self.world

    @property
    def first_shard(self) -> int:
        return self.rank * len(self.devices)

    def reduce(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """The ``psum``: the sum of this process's per-shard ``parts`` on
        the first shard's device, all-reduced over the group, copied back
        to each shard's device."""
        home = self.devices[0]
        total = parts[0].to(home)
        for p in parts[1:]:
            total = total + p.to(home)
        if self.group is not None:
            if len(parts) == 1:
                total = total.clone()       # all_reduce writes in place
            dist.all_reduce(total, group=self.group)
        return [total.to(d) for d in self.devices]

    def gather(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The shards' equal-size ``parts`` in global shard order, on the
        first shard's device (every rank receives the whole)."""
        home = self.devices[0]
        local = torch.cat([p.to(home) for p in parts])
        if self.group is None:
            return local
        as_bool = local.dtype == torch.bool
        if as_bool:
            local = local.to(torch.uint8)
        out = [torch.empty_like(local) for _ in range(self.world)]
        dist.all_gather(out, local, group=self.group)
        whole = torch.cat(out)
        return whole.bool() if as_bool else whole


def make_mesh() -> Mesh:
    """One shard on each visible CUDA device, as the JAX package's
    ``make_mesh`` takes ``jax.devices()``.  Raises where no CUDA device is
    visible: a mesh elsewhere is made by name with :func:`device_mesh`."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is visible; make a mesh "
                           "on a named device with device_mesh(device, n)")
    return Mesh([torch.device("cuda", i) for i in range(torch.cuda.device_count())])


def device_mesh(device, n_shards: int, group=None) -> Mesh:
    """``n_shards`` shards on one named device (``"cpu"``, ``"cuda:0"``):
    the stand-in for a mesh of several devices where one is present."""
    return Mesh([torch.device(device)] * n_shards, group)


def shard_problem(prob: BAProblem, mesh: Mesh) -> List[BAProblem]:
    """This process's shards of ``prob``: each takes its contiguous block
    of points and of observations, the cameras are copied to every shard.
    P and O must be multiples of the mesh's shard count (pad first;
    :func:`group_observations_by_point_shard` lays the observations out)."""
    n = mesh.n_shards
    P, O = prob.pnt_pos.shape[0], prob.obs_cam.shape[0]
    if P % n or O % n:
        raise ValueError(f"{P} points and {O} observations do not divide "
                         f"into {n} shards")
    per_p, per_o = P // n, O // n
    shards = []
    for i, dev in enumerate(mesh.devices):
        k = mesh.first_shard + i
        pts = slice(k * per_p, (k + 1) * per_p)
        obs = slice(k * per_o, (k + 1) * per_o)
        shards.append(BAProblem(
            cam_Tcw=prob.cam_Tcw.to(dev), cam_fixed=prob.cam_fixed.to(dev),
            pnt_pos=prob.pnt_pos[pts].to(dev),
            pnt_active=prob.pnt_active[pts].to(dev),
            obs_cam=prob.obs_cam[obs].to(dev), obs_pnt=prob.obs_pnt[obs].to(dev),
            obs_uvr=prob.obs_uvr[obs].to(dev),
            obs_inv_sigma2=prob.obs_inv_sigma2[obs].to(dev),
            obs_active=prob.obs_active[obs].to(dev), cam=prob.cam.to(dev)))
    return shards


def group_observations_by_point_shard(
    obs_pnt: np.ndarray, n_pnt: int, n_shards: int, arrays: Tuple[np.ndarray, ...],
) -> Tuple[np.ndarray, Tuple[np.ndarray, ...], np.ndarray]:
    """Reorder observations so each one lands on its point's owner shard.

    Points are block-partitioned (pnt_shard = pnt // (n_pnt // n_shards));
    observations are bucketed per shard and padded to equal length.
    Returns (new_obs_pnt, reordered arrays, active mask).
    """
    per = n_pnt // n_shards
    owner = np.minimum(obs_pnt // per, n_shards - 1)
    counts = np.bincount(owner, minlength=n_shards)
    cap = int(-(-counts.max() // 128) * 128)
    O = cap * n_shards
    new_pnt = np.zeros(O, obs_pnt.dtype)
    outs = [np.zeros((O,) + a.shape[1:], a.dtype) for a in arrays]
    active = np.zeros(O, bool)
    for s in range(n_shards):
        sel = np.nonzero(owner == s)[0]
        dst = slice(s * cap, s * cap + len(sel))
        new_pnt[dst] = obs_pnt[sel]
        for o, a in zip(outs, arrays):
            o[dst] = a[sel]
        active[dst] = True
    return new_pnt, tuple(outs), active


def _localize(shards: List[BAProblem], mesh: Mesh) -> List[BAProblem]:
    """Global point ids -> shard-local ones (int64, as the engines index
    with them); an observation whose point lies on another shard is
    switched off."""
    out = []
    for i, p in enumerate(shards):
        per = p.pnt_pos.shape[0]
        local = p.obs_pnt.long() - (mesh.first_shard + i) * per
        inside = (local >= 0) & (local < per)
        out.append(p._replace(obs_cam=p.obs_cam.long(),
                              obs_pnt=local.clamp(0, per - 1),
                              obs_active=p.obs_active & inside))
    return out


def _results(res, mesh: Mesh):
    """(cam_Tcw replicated, pnt_pos and obs_inlier of every shard) on the
    first shard's device."""
    return (res[0].cam_Tcw, mesh.gather([r.pnt_pos for r in res]),
            mesh.gather([r.obs_inlier for r in res]))


def _check_cams(shards: List[BAProblem], n_cam: int) -> None:
    if shards[0].cam_Tcw.shape[0] != n_cam:
        raise ValueError(f"n_cam {n_cam} against {shards[0].cam_Tcw.shape[0]} "
                         "cameras in the problem")


def _local_schur(prob: BAProblem, cam_Tcw, pnt_pos, active, lam, use_huber,
                 n_cam: int):
    """Per shard: the CG engine's local blocks and the local contribution
    to the dense reduced system, (Hcc, bc, S_sub, rhs_sub, Hpp_inv, W, bp,
    chi2)."""
    n_pnt = pnt_pos.shape[0]
    oc, op = prob.obs_cam.long(), prob.obs_pnt.long()
    Hcc, bc, Hpp_inv, bp, W, chi2 = ba_cg._local_blocks(
        prob, cam_Tcw, pnt_pos, active, lam, use_huber)

    def dense(blocks):
        # the JAX package's A.at[oc, :, op, :].add(W): a flat (C*P, 6, 3)
        # scatter, laid out as (6C, 3P)
        flat = torch.zeros((n_cam * n_pnt, 6, 3), dtype=W.dtype, device=W.device)
        flat.index_add_(0, oc * n_pnt + op, blocks)
        return flat.reshape(n_cam, n_pnt, 6, 3).permute(0, 2, 1, 3).reshape(
            n_cam * 6, n_pnt * 3)

    M2 = dense(_bmm(W, Hpp_inv[op]))
    S_sub = M2 @ dense(W).T
    rhs_sub = M2 @ bp.reshape(-1)
    return Hcc, bc, S_sub, rhs_sub, Hpp_inv, W, bp, chi2


def _lm_iteration_dense(probs, cams, pnts, active, lam, use_huber, mesh: Mesh,
                        n_cam: int):
    """One LM iteration of the dense sharded engine: one reduce each of
    Hcc, bc, S_sub, rhs_sub and the two costs."""
    loc = [_local_schur(p, c, x, a, lm, use_huber, n_cam)
           for p, c, x, a, lm in zip(probs, cams, pnts, active, lam)]
    Hcc, bc, S_sub, rhs_sub = (mesh.reduce([b[i] for b in loc]) for i in range(4))
    out, costs = [], []
    for s, (p, c, x, a, lm) in enumerate(zip(probs, cams, pnts, active, lam)):
        _, _, _, _, Hpp_inv, W, bp, chi2 = loc[s]
        eye6 = torch.eye(6, dtype=c.dtype, device=c.device)
        Hcc_d = Hcc[s] + lm * Hcc[s] * eye6 + 1e-8 * eye6
        dc = _solve_reduced(Hcc_d, S_sub[s], bc[s].reshape(-1) - rhs_sub[s],
                            p.cam_fixed)
        # local landmark back-substitution
        acc = _segment_sum(_btv(W, dc[p.obs_cam.long()]), p.obs_pnt.long(),
                           x.shape[0])
        pnt_new = x - _bmv(Hpp_inv, bp + acc) * p.pnt_active[:, None]
        cam_new = torch.where(p.cam_fixed[:, None, None], c, se3.retract(c, dc))
        e2, _, _, _ = _residuals(p, cam_new, pnt_new, light=True)
        c2 = torch.sum(e2 * e2, dim=-1) * p.obs_inv_sigma2
        costs.append(torch.stack([
            torch.sum(_robust_cost(chi2, HUBER_DELTA, use_huber) * a),
            torch.sum(_robust_cost(c2, HUBER_DELTA, use_huber) * a)]))
        out.append((cam_new, pnt_new))
    costs = mesh.reduce(costs)
    steps = [_accept(c, x, cn, xn, lm, cost[0], cost[1])
             for c, x, (cn, xn), lm, cost in zip(cams, pnts, out, lam, costs)]
    return tuple(list(v) for v in zip(*steps))


def distributed_bundle_adjust(shards: List[BAProblem], mesh: Mesh, n_cam: int,
                              iters1: int = 5, iters2: int = 10):
    """Sharded two-phase Schur LM on the dense reduced system; ``shards``
    from :func:`shard_problem`.  Returns (cam_Tcw, pnt_pos, obs_inlier),
    the last two over every shard, on the first shard's device."""
    _check_cams(shards, n_cam)
    step = functools.partial(_lm_iteration_dense, mesh=mesh, n_cam=n_cam)
    return _results(ba_cg._two_phase_shards(_localize(shards, mesh), step,
                                            iters1, iters2), mesh)


def distributed_bundle_adjust_cg(shards: List[BAProblem], mesh: Mesh,
                                 n_cam: int, iters1: int = 5, iters2: int = 10,
                                 cg_iters: int = 64):
    """Distributed implicit-Schur PCG bundle adjustment, the global-BA
    engine.  Unlike :func:`distributed_bundle_adjust` it never forms S:
    each CG step's matrix-vector product is local segment sums plus ONE
    (C, 6) reduce.  The CG state is camera-space and replicated, so its dot
    products need no communication.  Returns what
    :func:`distributed_bundle_adjust` returns."""
    _check_cams(shards, n_cam)
    return _results(ba_cg._bundle_adjust_cg_core(
        _localize(shards, mesh), iters1, iters2, cg_iters, mesh.reduce), mesh)
