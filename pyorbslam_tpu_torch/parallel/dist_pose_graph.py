"""Distributed Sim3 pose-graph (essential graph) optimization over a mesh.

Port of ``pyorbslam_tpu/parallel/dist_pose_graph.py``: the edges (loop
connections, spanning tree, strong covisibles) are partitioned across the
shards of a :class:`~pyorbslam_tpu_torch.parallel.dist_ba.Mesh`, the Sim3
vertex state (C keyframes) is replicated.  Each LM step is the CG solver
of :func:`optim.pose_graph.optimize_pose_graph_cg` with its vertex-space
sums reduced over the shards: ``b`` and ``D`` once per LM step, the CG
matrix-vector product once per CG step (7C floats), the two costs once.
The CG state itself stays replicated, so its dot products need no
communication.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.geometry.sim3 import Sim3
from pyorbslam_tpu_torch.optim.pose_graph import PoseGraphResult, _pose_graph_cg_shards
from pyorbslam_tpu_torch.parallel.dist_ba import Mesh


def pad_edges(
    n_shards: int,
    e_i: np.ndarray, e_j: np.ndarray,
    m_R: np.ndarray, m_t: np.ndarray, m_s: np.ndarray,
    e_active: np.ndarray,
) -> Tuple[np.ndarray, ...]:
    """Pad the edge list to a multiple of the shard count (inactive
    self-loop edges on vertex 0)."""
    E = len(e_i)
    Ep = -(-max(E, 1) // n_shards) * n_shards
    pad = Ep - E

    def z(a, fill=0):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a

    eye = np.broadcast_to(np.eye(3, dtype=m_R.dtype), (pad, 3, 3))
    m_R2 = np.concatenate([m_R, eye]) if pad else m_R
    return (z(e_i), z(e_j), m_R2, z(m_t), z(m_s, 1),
            np.concatenate([e_active, np.zeros(pad, bool)]) if pad else e_active)


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))


def place_pose_graph(mesh: Mesh, arrays: Sequence, edge_arrays: Sequence):
    """The vertex ``arrays`` replicated and the ``edge_arrays`` split into
    this process's shards (E a multiple of the shard count; see
    :func:`pad_edges`): one list of per-shard tensors for each array."""
    per = len(edge_arrays[0]) // mesh.n_shards
    reps = [[_tensor(a).to(d) for d in mesh.devices] for a in arrays]
    shds = [[_tensor(a)[(mesh.first_shard + i) * per:
                        (mesh.first_shard + i + 1) * per].to(d)
             for i, d in enumerate(mesh.devices)] for a in edge_arrays]
    return reps, shds


def distributed_pose_graph(
    mesh: Mesh,
    R: List[torch.Tensor], t: List[torch.Tensor], s: List[torch.Tensor],
    fixed: List[torch.Tensor],                         # replicated, per shard
    e_i: List[torch.Tensor], e_j: List[torch.Tensor],  # sharded, per shard
    m_R: List[torch.Tensor], m_t: List[torch.Tensor], m_s: List[torch.Tensor],
    e_active: List[torch.Tensor],
    iters: int = 20, fix_scale: bool = True, cg_iters: int = 96,
) -> PoseGraphResult:
    """The essential graph over the mesh, from :func:`place_pose_graph`'s
    lists.  Returns the corrected Siw on the first shard's device."""
    states = [Sim3(R=a, t=b, s=c) for a, b, c in zip(R, t, s)]
    edges = [(a.long(), b.long(), Sim3(R=mr, t=mt, s=ms), w.to(mt.dtype))
             for a, b, mr, mt, ms, w in zip(e_i, e_j, m_R, m_t, m_s, e_active)]
    state = _pose_graph_cg_shards(states, fixed, edges, iters, fix_scale,
                                  cg_iters, mesh.reduce)[0]
    return PoseGraphResult(R=state.R, t=state.t, s=state.s)
