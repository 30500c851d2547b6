"""Scaling report of the port's distributed bundle adjustment: one fixed
synthetic problem (the repository's ``tools/scaling_report.py``'s: same
seed, cameras, points and observations) solved by
``parallel/dist_ba.py::distributed_bundle_adjust`` on meshes of 1, 2, 4
and 8 shards.  One JSON line a mesh, with the keys of the repository's
tool and the device's name.

    python3 -m pyorbslam_tpu_torch.tools.scaling_report [--devices 1 2 4 8]
        [--cams 128] [--points 32768] [--obs-per-cam 1024] [--iters 10] [--cpu]

A mesh takes one shard on each of its first N CUDA devices; a mesh larger
than the number of cards prints ``"skipped": "not enough devices"``.
Without a CUDA device the command fails unless ``--cpu`` is given, which
puts every shard of each mesh on the CPU (``dist_ba.device_mesh``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from pyorbslam_tpu_torch.optim.ba import BAProblem
from pyorbslam_tpu_torch.parallel import dist_ba
from pyorbslam_tpu_torch.utils.device import device_line, device_of

FX, CX, CY, BF = 718.0, 607.0, 185.0, 386.0


def make_problem(n_cams: int, n_points: int, obs_per_cam: int):
    """The report's problem: points in a 40 x 6 x 56 m box, cameras every
    0.4 m along x, each observing ``obs_per_cam`` distinct points, exact
    stereo observations, the points' starting positions noised by 5 cm.
    Returns (true points, noisy points, cam_Tcw, obs_cam, obs_pnt, obs_uvr)."""
    rng = np.random.default_rng(0)
    pts = np.stack([
        rng.uniform(-20, 20, n_points), rng.uniform(-3, 3, n_points),
        rng.uniform(4, 60, n_points)], 1).astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (n_cams, 1, 1))
    cams[:, 0, 3] = -0.4 * np.arange(n_cams)
    obs_cam, obs_pnt = [], []
    for c in range(n_cams):
        ids = rng.choice(n_points, obs_per_cam, replace=False)
        obs_cam.append(np.full(obs_per_cam, c, np.int32))
        obs_pnt.append(ids.astype(np.int32))
    obs_cam = np.concatenate(obs_cam)
    obs_pnt = np.concatenate(obs_pnt)
    Pc = np.einsum("oij,oj->oi", cams[obs_cam, :3, :3], pts[obs_pnt]) \
        + cams[obs_cam, :3, 3]
    z = np.maximum(Pc[:, 2], 0.5)
    u = FX * Pc[:, 0] / z + CX
    v = FX * Pc[:, 1] / z + CY
    obs_uvr = np.stack([u, v, u - BF / z], 1).astype(np.float32)
    noisy = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    return pts, noisy, cams, obs_cam, obs_pnt, obs_uvr


def solve(mesh: dist_ba.Mesh, problem, iters: int):
    """The problem sharded over ``mesh`` and solved; (seconds of the timed
    solve after a warm one, observations after padding, solved points)."""
    pts, noisy, cams, obs_cam, obs_pnt, obs_uvr = problem
    C, P = len(cams), len(pts)
    new_pnt, (oc, ouvr), active = dist_ba.group_observations_by_point_shard(
        obs_pnt, P, mesh.n_shards, (obs_cam, obs_uvr))
    prob = BAProblem(
        cam_Tcw=torch.from_numpy(cams), cam_fixed=torch.from_numpy(np.arange(C) == 0),
        pnt_pos=torch.from_numpy(noisy), pnt_active=torch.ones(P, dtype=torch.bool),
        obs_cam=torch.from_numpy(oc), obs_pnt=torch.from_numpy(new_pnt),
        obs_uvr=torch.from_numpy(ouvr),
        obs_inv_sigma2=torch.ones(len(oc), dtype=torch.float32),
        obs_active=torch.from_numpy(active),
        cam=torch.tensor([FX, FX, CX, CY, BF], dtype=torch.float32))
    shards = dist_ba.shard_problem(prob, mesh)
    first = mesh.devices[0]

    def run():
        out = dist_ba.distributed_bundle_adjust(
            shards, mesh, n_cam=C, iters1=iters // 2, iters2=iters - iters // 2)
        if first.type == "cuda":
            torch.cuda.synchronize(first)
        return out

    run()                               # warm
    t0 = time.perf_counter()
    out = run()
    return time.perf_counter() - t0, len(oc), out[1].cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--cams", type=int, default=128)
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--obs-per-cam", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true",
                    help="every shard on the CPU instead of one a card")
    args = ap.parse_args(argv)
    device = device_of("cpu" if args.cpu else "cuda")
    cards = [] if args.cpu else list(dist_ba.make_mesh().devices)

    problem = make_problem(args.cams, args.points, args.obs_per_cam)
    lines = []
    for nd in args.devices:
        if args.cpu:
            mesh = dist_ba.device_mesh(device, nd)
        elif nd > len(cards):
            lines.append({"metric": "dist_ba_step_time_s", "devices": nd,
                          "skipped": "not enough devices"})
            print(json.dumps(lines[-1]), flush=True)
            continue
        else:
            mesh = dist_ba.Mesh(cards[:nd])
        dt, n_obs, solved = solve(mesh, problem, args.iters)
        lines.append({
            "metric": "dist_ba_step_time_s", "devices": nd,
            "value": round(dt, 4), "cams": args.cams, "points": args.points,
            "obs": n_obs, "iters": args.iters,
            "mean_point_err": round(float(np.abs(solved - problem[0]).mean()), 4),
            "backend": device.type, "device": device_line(device),
        })
        print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
