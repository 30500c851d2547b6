"""Accuracy of the windowed schedules against the per-frame one.

    python3 -m pyorbslam_tpu_torch.tools.window_envelope [--device cuda]
        [--width 1241 --height 376 --features 2000] [--speed 0.8]
        [--modes per_frame,window,feed] [--perturb 0,1,2] [--cache-dir DIR]

Renders the straight synthetic sequence (34 frames, seed 3) at the given
size and speed and runs the default ``System`` over it once per mode and
per perturbation seed: ``per_frame`` (``track_stereo``), ``window``
(``track_stereo_window`` in windows of 4) and ``feed`` (``window_feed`` +
``window_flush``).  Perturbation seed ``s > 0`` adds one grey level to
0.01% of the pixels, drawn from ``s``; seed 0 leaves the images as
rendered.  Prints one JSON line per run: ATE and drift against the ground
truth, keyframes, frames/s on the host clock, the schedule's string
events, the ``window.*`` timers, the landmark bindings that repeat
inside one committed frame (one landmark bound to two features of a
frame), and how far the committed rotations are from orthonormal (the
largest entry of |R R^T - I| over the trajectory).  With a CUDA device
the first line is the card's ``nvidia-smi`` name and power limit.  Any
device runs it; the default is ``cuda``.

:func:`run` takes a ``System`` made by the caller, so the tests drive the
JAX package's ``System`` through the same loop.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import Counter

import numpy as np
import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.utils.metrics import ate_rmse

WINDOW = 4
TIMERS = ("window.dispatch", "window.read", "window.commit_total",
          "window.retrack", "perframe.track")


def perturbed(left: np.ndarray, right: np.ndarray, seed: int):
    """The images with one grey level added to 0.01% of the pixels (seed 0:
    unchanged)."""
    left, right = left.copy(), right.copy()
    if seed:
        rng = np.random.default_rng(seed)
        for a in (left, right):
            m = rng.random(a.shape) < 1e-4
            a[m] = np.clip(a[m].astype(np.int64) + 1, 0, 255).astype(a.dtype)
    return left, right


def run(system, seq, mode: str, seed: int = 0, window: int = WINDOW):
    """Drive ``system`` (either package's ``System``) over ``seq`` in
    ``mode``, then flush and shut it down.  Returns (record, the poses the
    schedule returned)."""
    n = seq.left.shape[0]
    left, right = perturbed(seq.left, seq.right, seed)
    repeats = []
    finish = system._finish_track

    def counted_finish(frame, assign, *args):
        ids = np.asarray(assign)
        ids = ids[ids >= 0]
        repeats.append(int(len(ids) - len(np.unique(ids))))
        return finish(frame, assign, *args)

    system._finish_track = counted_finish
    poses = []
    t0 = time.perf_counter()
    step = 1 if mode == "per_frame" else window
    for w0 in range(0, n, step):
        w = slice(w0, w0 + step)
        if mode == "per_frame":
            poses.append(system.track_stereo(left[w0], right[w0], seq.timestamps[w0]))
        elif mode == "window":
            poses.extend(system.track_stereo_window(left[w], right[w], seq.timestamps[w]))
        else:
            poses.extend(system.window_feed(left[w], right[w], seq.timestamps[w]))
    poses.extend(system.window_flush())
    system.shutdown()
    elapsed = time.perf_counter() - t0
    del system._finish_track
    gt = seq.poses_wc[:n]
    est = np.linalg.inv(np.asarray(system.corrected_trajectory(), np.float64))
    ate = ate_rmse(est, gt)
    length = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    R = np.stack(system.trajectory).astype(np.float64)[:, :3, :3]
    rec = dict(mode=mode, window=window if mode != "per_frame" else None,
               perturb=seed, frames=len(system.trajectory), ate=ate,
               drift=ate / length, keyframes=int(system.map.keyframes.n),
               fps=n / elapsed,
               events=dict(Counter(e for e in system.events if isinstance(e, str))),
               repeated_bindings=dict(mean=float(np.mean(repeats)) if repeats else 0.0,
                                      max=max(repeats, default=0)),
               rotation_error=float(np.abs(
                   R @ R.transpose(0, 2, 1) - np.eye(3)).max()))
    for label in TIMERS:
        k = system.time_counts[label]
        if k:
            rec[label + "_ms"] = 1e3 * system.times[label] / k
    return rec, poses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--speed", type=float, default=0.8)
    ap.add_argument("--modes", default="per_frame,window,feed")
    ap.add_argument("--perturb", default="0")
    ap.add_argument("--cache-dir", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip(),
            flush=True)
    seq = generate_sequence(n_frames=34, width=args.width, height=args.height,
                            trajectory="straight", speed=args.speed, seed=3,
                            cache_dir=args.cache_dir)
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=args.width, height=args.height, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=args.features))
    for seed in (int(s) for s in args.perturb.split(",")):
        for mode in args.modes.split(","):
            rec, _ = run(System(cfg, device, keyframe_capacity=256), seq, mode, seed)
            rec.update(device=str(device), size=f"{args.width}x{args.height}",
                       features=args.features, speed=args.speed)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
