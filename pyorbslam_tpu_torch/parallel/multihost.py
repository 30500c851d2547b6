"""Multi-process runtime for the sharded engines.

Port of ``pyorbslam_tpu/parallel/multihost.py``.  The engines of
``parallel/dist_ba.py`` and ``parallel/dist_pose_graph.py`` run unchanged
over a mesh whose shards span processes: :meth:`Mesh.reduce` adds a
``torch.distributed.all_reduce`` over the mesh's group to its local sum.
So running across processes is a matter of initialization, not a second
code path.

The backend follows the device the caller names: NCCL for CUDA, gloo for
the CPU.  Two NCCL ranks cannot share one GPU, so several ranks on one
machine with one card run on the CPU, over gloo
(``tools/multihost_dryrun.py``); on the card NCCL runs with one rank per
GPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from pyorbslam_tpu_torch.parallel.dist_ba import Mesh, device_mesh, make_mesh

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def initialize(address: str, num_processes: int, process_id: int,
               device="cuda", timeout: Optional[datetime.timedelta] = None
               ) -> None:
    """``torch.distributed.init_process_group`` over ``address``
    (``"tcp://localhost:<port>"``): NCCL where ``device`` is a CUDA device,
    gloo where it is the CPU.  ``timeout`` bounds each collective's wait
    for the other ranks.  Pair with :func:`shutdown` in a ``finally``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {device}")
    kwargs = {} if timeout is None else dict(timeout=timeout)
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id, **kwargs)


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(device=None, n_local: int = 1) -> Mesh:
    """The mesh over every process of the job: this process's shards and
    the WORLD group.  Without ``device`` each visible CUDA device is one
    shard (as :func:`dist_ba.make_mesh`); with it, ``n_local`` shards on
    that device."""
    group = dist.group.WORLD
    if device is None:
        return Mesh(make_mesh().devices, group)
    return device_mesh(device, n_local, group)


def dryrun_env() -> dict:
    """Environment for a CPU worker process: no CUDA device visible, one
    OpenMP thread, and this checkout importable."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    path = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = _REPO + (os.pathsep + path if path else "")
    return env
