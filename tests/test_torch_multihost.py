"""The port's sharded engines across process boundaries: two processes of
two CPU shards each, joined in one gloo group
(``pyorbslam_tpu_torch/tools/multihost_dryrun.py``), against the same
solves on a one-process mesh of four shards.

The workers run as subprocesses of the tool, each under a time limit
(and the gloo group under a timeout), so a rank that fails cannot leave
this test waiting.  Tolerance: camera translations within 2e-3 m (the
JAX package's ``tests/test_dist_ba.py``), for the BA and the pose graph.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from pyorbslam_tpu_torch.parallel import dist_ba
from pyorbslam_tpu_torch.tools import multihost_dryrun as dryrun

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3
WORKER_S = 240


def test_two_processes_of_two_shards():
    out = subprocess.run(
        [sys.executable, "-m", "pyorbslam_tpu_torch.tools.multihost_dryrun",
         "--procs", "2", "--local-shards", "2", "--timeout", str(WORKER_S)],
        cwd=REPO, capture_output=True, text=True, timeout=WORKER_S + 60)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert (res["processes"], res["local_shards"], res["shards"]) == (2, 2, 4)
    # rank 0's own comparisons: the one-process mesh and one device
    assert res["ba_max_dt_vs_one_process"] < TOL, res
    assert res["ba_max_dt_vs_one_device"] < TOL, res
    assert res["pg_max_dt_vs_one_process"] < TOL, res
    assert res["pg_max_dR_vs_one_process"] < TOL, res
    assert res["ba_cam_err"] < 2.0 * res["ba_cam_err_one_device"] + 1e-3, res
    assert res["pg_centre_err"] < max(1.5 * res["pg_centre_err_one_device"], 0.25)

    # and this process's own one-process 4-shard solve of the same problem
    prob, _ = dryrun.ba_problem()
    cam = dryrun.solve_ba(prob, dist_ba.device_mesh("cpu", 4)).numpy()
    np.testing.assert_allclose(np.asarray(res["ba_cam_t"]), cam[:, :3, 3],
                               atol=TOL)
