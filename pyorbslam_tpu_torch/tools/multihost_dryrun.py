"""The sharded BA and pose-graph engines across process boundaries.

    python3 -m pyorbslam_tpu_torch.tools.multihost_dryrun [--procs 2]
        [--local-shards 2] [--timeout 300]

The port of the repository's ``tools/multihost_dryrun.py``.  The parent
starts ``--procs`` worker processes on the CPU (``multihost.dryrun_env``),
each holding ``--local-shards`` shards, joined in one gloo group over
``tcp://localhost:<free port>``.  Every worker runs the same engines the
single-process ``System`` uses, ``parallel/dist_ba.py``'s
``distributed_bundle_adjust_cg`` and ``parallel/dist_pose_graph.py``'s
``distributed_pose_graph``, with their reduces now crossing processes.
Rank 0 repeats both solves in its own process, on a one-process mesh of
as many shards and on one device, and the parent prints rank 0's JSON
line: the largest camera-translation differences against those, errors
against the ground truth, wall times and the solved translations.  It
writes no file.

Each worker has a time limit, the gloo group a timeout, and every worker
leaves its group in a ``finally``: a rank that raises cannot leave the
others waiting in an ``all_reduce`` for good.
"""

from __future__ import annotations

import argparse
import datetime
import json
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from pyorbslam_tpu_torch.geometry import se3
from pyorbslam_tpu_torch.optim import ba_cg
from pyorbslam_tpu_torch.optim.ba import BAProblem
from pyorbslam_tpu_torch.optim.pose_graph import optimize_pose_graph_cg
from pyorbslam_tpu_torch.parallel import dist_ba, dist_pose_graph, multihost
from pyorbslam_tpu_torch.tools.gba_tiling import centres

CPU = torch.device("cpu")
BA_ITERS = dict(iters1=5, iters2=10, cg_iters=64)
PG_CG_ITERS = 128
PG_GRAPH = (5, 24, 8.0, 0.008, 0.04)   # drift_graph's seed, C, radius, sds


def _exp_se3(xi: np.ndarray) -> np.ndarray:
    return se3.exp_se3(torch.from_numpy(xi.astype(np.float32))).numpy()


def ba_problem():
    """A stereo BA problem on the CPU: 8 cameras along a line looking +z,
    504 points in front (8 padding slots after them), observations noised
    by 0.3 px, starting poses and points noised (camera 0 fixed at the
    truth).  Returns (problem, true Tcw)."""
    n_cam, n_pnt, pad_pnt = 8, 504, 8
    pose_noise, pnt_noise = 0.05, 0.10
    rng = np.random.default_rng(7)
    fx = fy = 400.0
    cx, cy, bf = 320.0, 120.0, 180.0
    T_true = np.tile(np.eye(4, dtype=np.float32), (n_cam, 1, 1))
    for i in range(n_cam):
        T_true[i, :3, 3] = [-0.8 * i + rng.normal(0, 0.1), rng.normal(0, 0.05),
                            rng.normal(0, 0.1)]
    pts = np.stack([rng.uniform(-12, 12, n_pnt), rng.uniform(-4, 4, n_pnt),
                    rng.uniform(6, 40, n_pnt)], 1).astype(np.float32)
    oc, op, uvr = [], [], []
    for c in range(n_cam):
        Pc = pts @ T_true[c, :3, :3].T + T_true[c, :3, 3]
        u = fx * Pc[:, 0] / Pc[:, 2] + cx
        v = fy * Pc[:, 1] / Pc[:, 2] + cy
        ids = np.nonzero((Pc[:, 2] > 1) & (u > 0) & (u < 640) & (v > 0)
                         & (v < 240))[0]
        oc += [c] * len(ids)
        op += ids.tolist()
        uvr.append(np.stack([u[ids], v[ids], u[ids] - bf / Pc[ids, 2]], 1))
    uvr = np.concatenate(uvr).astype(np.float32)
    uvr += rng.normal(0, 0.3, uvr.shape).astype(np.float32)
    T0 = T_true.copy()
    for i in range(1, n_cam):
        xi = np.concatenate([rng.normal(0, pose_noise * 0.2, 3),
                             rng.normal(0, pose_noise, 3)])
        T0[i] = _exp_se3(xi) @ T_true[i]
    p0 = pts + rng.normal(0, pnt_noise, pts.shape).astype(np.float32)
    O = len(oc)
    t = torch.from_numpy
    prob = BAProblem(
        cam_Tcw=t(T0), cam_fixed=t(np.arange(n_cam) == 0),
        pnt_pos=t(np.concatenate([p0, np.zeros((pad_pnt, 3), np.float32)])),
        pnt_active=t(np.arange(n_pnt + pad_pnt) < n_pnt),
        obs_cam=t(np.asarray(oc, np.int32)), obs_pnt=t(np.asarray(op, np.int32)),
        obs_uvr=t(uvr), obs_inv_sigma2=torch.ones(O),
        obs_active=torch.ones(O, dtype=torch.bool),
        cam=t(np.asarray([fx, fy, cx, cy, bf], np.float32)))
    return prob, T_true


def group_for_shards(prob: BAProblem, n_shards: int) -> BAProblem:
    """``prob`` with its observations on their points' owner shards."""
    new_pnt, (oc, uvr, isig), act = dist_ba.group_observations_by_point_shard(
        prob.obs_pnt.numpy(), prob.pnt_pos.shape[0], n_shards,
        (prob.obs_cam.numpy(), prob.obs_uvr.numpy(),
         prob.obs_inv_sigma2.numpy()))
    t = torch.from_numpy
    return prob._replace(obs_pnt=t(new_pnt), obs_cam=t(oc), obs_uvr=t(uvr),
                         obs_inv_sigma2=t(isig), obs_active=t(act))


def drift_graph(seed: int, C: int, radius: float, rot_sd: float, trans_sd: float):
    """A circle of C keyframes, odometry edges measured from poses that
    drift by (rot_sd, trans_sd) a step, and one loop edge to the start
    measured from the truth (the JAX package's ``tests/test_sim3.py``).
    Returns (true Tcw, drifted Tcw, the ten arrays of
    ``optimize_pose_graph_cg``: four of vertices, six of edges)."""
    rng = np.random.default_rng(seed)
    gt = []
    for i in range(C):
        ang = 2 * np.pi * i / C
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = se3.exp_so3(torch.tensor([0.0, ang, 0.0])).numpy()
        Twc[:3, 3] = [radius * np.sin(ang), 0, radius * (1 - np.cos(ang))]
        gt.append(np.linalg.inv(Twc).astype(np.float32))
    est = [gt[0]]
    for i in range(1, C):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        xi = np.concatenate([rng.normal(0, rot_sd, 3), rng.normal(0, trans_sd, 3)])
        est.append((_exp_se3(xi) @ rel @ est[-1]).astype(np.float32))
    gt, est = np.stack(gt), np.stack(est)
    e_i, e_j, mR, mt = list(range(C - 1)), list(range(1, C)), [], []
    for i in range(C - 1):
        Sji = est[i + 1] @ np.linalg.inv(est[i])
        mR.append(Sji[:3, :3])
        mt.append(Sji[:3, 3])
    loop = gt[0] @ np.linalg.inv(gt[C - 1])
    e_i.append(C - 1)
    e_j.append(0)
    mR.append(loop[:3, :3])
    mt.append(loop[:3, 3])
    E = len(e_i)
    args = [est[:, :3, :3].copy(), est[:, :3, 3].copy(), np.ones(C, np.float32),
            np.arange(C) == 0, np.asarray(e_i, np.int32), np.asarray(e_j, np.int32),
            np.stack(mR).astype(np.float32), np.stack(mt).astype(np.float32),
            np.ones(E, np.float32), np.ones(E, bool)]
    return gt, est, args


def solve_ba(prob: BAProblem, mesh) -> torch.Tensor:
    """The sharded CG BA of ``prob`` over ``mesh``: the solved Tcw."""
    grouped = group_for_shards(prob, mesh.n_shards)
    cam, _, _ = dist_ba.distributed_bundle_adjust_cg(
        dist_ba.shard_problem(grouped, mesh), mesh,
        n_cam=prob.cam_Tcw.shape[0], **BA_ITERS)
    return cam


def solve_pose_graph(args, mesh):
    """The sharded essential graph of ``drift_graph``'s ``args`` over
    ``mesh``: (R, t)."""
    pe = dist_pose_graph.pad_edges(mesh.n_shards, *args[4:])
    reps, shds = dist_pose_graph.place_pose_graph(mesh, args[:4], list(pe))
    res = dist_pose_graph.distributed_pose_graph(mesh, *reps, *shds,
                                                 cg_iters=PG_CG_ITERS)
    return res.R, res.t


def worker(args) -> None:
    multihost.initialize(args.address, args.procs, args.worker, CPU,
                         timeout=datetime.timedelta(seconds=args.timeout))
    try:
        torch.set_num_threads(1)
        mesh = multihost.global_mesh(CPU, args.local_shards)
        prob, T_true = ba_problem()
        gt, _, args_pg = drift_graph(*PG_GRAPH)
        t0 = time.perf_counter()
        cam = solve_ba(prob, mesh).numpy()
        ba_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        R, t = (a.numpy() for a in solve_pose_graph(args_pg, mesh))
        pg_s = time.perf_counter() - t0
        if args.worker != 0:
            return
        one = dist_ba.device_mesh(CPU, mesh.n_shards)
        cam_1p = solve_ba(prob, one).numpy()
        cam_1d = ba_cg.bundle_adjust_cg(prob, **BA_ITERS).cam_Tcw.numpy()
        R_1p, t_1p = (a.numpy() for a in solve_pose_graph(args_pg, one))
        ref = optimize_pose_graph_cg(*(torch.from_numpy(np.asarray(a))
                                       for a in args_pg),
                                     cg_iters=PG_CG_ITERS)
        n = T_true.shape[0]
        c_gt = centres(gt[:, :3, :3], gt[:, :3, 3])
        out = dict(
            processes=args.procs, local_shards=args.local_shards,
            shards=mesh.n_shards,
            ba_max_dt_vs_one_process=float(np.abs(
                cam[:, :3, 3] - cam_1p[:, :3, 3]).max()),
            ba_max_dt_vs_one_device=float(np.abs(
                cam[:, :3, 3] - cam_1d[:, :3, 3]).max()),
            ba_cam_err=float(np.linalg.norm(
                cam[:n, :3, 3] - T_true[:, :3, 3], axis=1).max()),
            ba_cam_err_one_device=float(np.linalg.norm(
                cam_1d[:n, :3, 3] - T_true[:, :3, 3], axis=1).max()),
            ba_wall_s=ba_s,
            pg_max_dt_vs_one_process=float(np.abs(t - t_1p).max()),
            pg_max_dR_vs_one_process=float(np.abs(R - R_1p).max()),
            pg_max_dt_vs_one_device=float(np.abs(t - ref.t.numpy()).max()),
            pg_centre_err=float(np.linalg.norm(centres(R, t) - c_gt,
                                               axis=1).max()),
            pg_centre_err_one_device=float(np.linalg.norm(
                centres(ref.R.numpy(), ref.t.numpy()) - c_gt, axis=1).max()),
            pg_wall_s=pg_s,
            ba_cam_t=cam[:, :3, 3].tolist(), pg_t=t.tolist(), pg_R=R.tolist())
        print(json.dumps(out), flush=True)
    finally:
        multihost.shutdown()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(procs: int, local_shards: int, timeout: float) -> dict:
    """Start the workers, wait for them (each within ``timeout`` s) and
    return rank 0's result."""
    address = f"tcp://localhost:{free_port()}"
    env = multihost.dryrun_env()
    cmd = [sys.executable, "-m", "pyorbslam_tpu_torch.tools.multihost_dryrun",
           "--procs", str(procs), "--local-shards", str(local_shards),
           "--address", address, "--timeout", str(timeout)]
    workers = [subprocess.Popen(cmd + ["--worker", str(i)], env=env,
                                stdout=subprocess.PIPE, text=True)
               for i in range(procs)]
    outs, rcs = [], []
    try:
        for w in workers:
            outs.append(w.communicate(timeout=timeout)[0])
            rcs.append(w.returncode)
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    if any(rcs):
        raise RuntimeError(f"worker exit codes {rcs}")
    return json.loads(outs[0].strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-shards", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds each worker may take")
    ap.add_argument("--worker", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--address", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker >= 0:
        worker(args)
        return
    t0 = time.perf_counter()
    res = run(args.procs, args.local_shards, args.timeout)
    res["wall_s"] = time.perf_counter() - t0
    res["config"] = (f"{args.procs} processes x {args.local_shards} CPU shards, "
                     "gloo")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
