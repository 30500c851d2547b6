"""Batch trajectory evaluation of the port: the synthetic stand-in for the
KITTI 00-10 sweep (no KITTI sequence ships with the repository).

Runs the whole ``System`` (tracking, local mapping, local BA, loop
closing, global BA after a closure) over four synthetic sequences and
prints an ATE / RPE table and one JSON summary line.

    python3 -m pyorbslam_tpu_torch.tools.eval_synth [--frames 60]
        [--width 512] [--height 160] [--features 1000] [--window 0]
        [--quick] [--device cuda] [--cache-dir DIR]

``--window W`` tracks W frames a dispatch (``track_stereo_window``; a
tail shorter than a window frame by frame); 0 tracks every frame with
``track_stereo``.  ``--quick`` runs the first two sequences only.
``--device`` names the device every step runs on (default ``cuda``);
nothing falls back: with ``cuda`` and no CUDA device the command fails.
``--cache-dir`` keeps the rendered sequences (npz) for later runs.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.utils.device import device_line, device_of
from pyorbslam_tpu_torch.utils.metrics import ate_rmse, rpe

SEQUENCES = [
    # name, trajectory, n_frames multiplier, seed
    ("straight-0", "straight", 1.0, 3),
    ("straight-1", "straight", 1.0, 7),
    ("turn-0", "turn", 1.0, 5),
    ("loop-0", "loop", 1.6, 11),
]
# "turn" names no trajectory of io/synthetic.py (nor of the JAX package's
# generator, on which the repository's tools/eval_synth.py raises at
# turn-0 unless --quick): here it is a quarter lap of the loop trajectory,
# a 90-degree turn
TRAJECTORIES = dict(turn=dict(trajectory="loop", laps=0.25))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--quick", action="store_true", help="first two sequences only")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every step (default: cuda)")
    ap.add_argument("--cache-dir", default=None,
                    help="keep rendered sequences here (npz); none by default")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    rows = []
    for name, traj, mult, seed in (SEQUENCES[:2] if args.quick else SEQUENCES):
        n = int(args.frames * mult)
        seq = generate_sequence(n_frames=n, width=args.width, height=args.height,
                                seed=seed, cache_dir=args.cache_dir,
                                **TRAJECTORIES.get(traj, dict(trajectory=traj)))
        cfg = SlamConfig(
            camera=CameraConfig(
                fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
                cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
                width=args.width, height=args.height, bf=seq.bf, th_depth=40.0),
            orb=OrbConfig(n_features=args.features),
        )
        system = System(cfg, device)
        t0 = time.perf_counter()
        W = args.window
        n_win = n - n % W if W else 0
        for w0 in range(0, n_win, W or 1):
            system.track_stereo_window(seq.left[w0: w0 + W], seq.right[w0: w0 + W],
                                       seq.timestamps[w0: w0 + W])
        for i in range(n_win, n):
            system.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        system.shutdown()
        dt = time.perf_counter() - t0
        est_wc = np.linalg.inv(system.corrected_trajectory().astype(np.float64))
        gt = seq.poses_wc[:n]
        rpe_t, rpe_r = rpe(est_wc, gt)
        lc = system.loop_closer
        rows.append(dict(
            seq=name, frames=n,
            path_m=float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum()),
            ate_rmse_m=ate_rmse(est_wc, gt), rpe_t_m=float(rpe_t),
            rpe_r_deg=float(np.degrees(rpe_r)), kfs=int(system.map.keyframes.n),
            loops=lc.n_loops_closed if lc else 0, fps=n / dt))
        r = rows[-1]
        print(f"{name:12s} frames={n:3d} path={r['path_m']:6.1f}m "
              f"ATE={r['ate_rmse_m']:.3f}m RPE={r['rpe_t_m']:.3f}m/"
              f"{r['rpe_r_deg']:.3f}deg kfs={r['kfs']} loops={r['loops']} "
              f"{r['fps']:.2f} fps", flush=True)

    ates = [r["ate_rmse_m"] for r in rows]
    print(json.dumps(dict(
        metric="synthetic_batch_eval", mean_ate_rmse_m=float(np.mean(ates)),
        max_ate_rmse_m=float(np.max(ates)), device=device_line(device),
        sequences=rows)))


if __name__ == "__main__":
    main()
