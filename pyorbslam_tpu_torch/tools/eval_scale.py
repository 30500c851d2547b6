"""Scale run of the port: a KITTI-00-shaped synthetic sequence (hundreds
to thousands of frames, a loop of several laps with repeated revisits)
through the whole ``System``: keyframe culling, the essential graph and
global BA at the map sizes they exist for.

    python3 -m pyorbslam_tpu_torch.tools.eval_scale [--frames 1000]
        [--width 1241] [--height 376] [--features 2000] [--laps 2.2]
        [--radius 60] [--window 0] [--scene corridor|interior] [--no-loop]
        [--render-backend numpy|torch] [--device cuda] [--cache-dir DIR]

``--window 0`` (the default) is the pipelined per-frame schedule
(``track_stereo_async`` on every frame, then ``flush_async``); ``--window
W`` feeds windows of W frames (``window_feed``, then ``window_flush``).
``--render-backend torch`` renders on ``--device`` with
``io/render_torch.py``.  ``--device`` names the device every step runs on
(default ``cuda``); nothing falls back: with ``cuda`` and no CUDA device
the command fails.

Every frame is rendered (or read from ``--cache-dir``'s stream cache)
before the timed loop, so the renderer's work never sits inside the SLAM
clock; ``render_s`` reports it apart.  Prints a progress block every 100
frames and, last, one JSON line: the keys of the repository's
``tools/eval_scale.py`` and ``device`` (the card's ``nvidia-smi`` name and
power limit, or ``cpu``), ``peak_device_mb``
(``torch.cuda.max_memory_allocated``; null on the CPU),
``frames_per_s_first_100`` / ``frames_per_s_last_100`` (host clock; the
last span ends after the final flush), and the ``System`` and loop
closer stage totals in seconds.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import SyntheticStream
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.utils.device import device_line, device_of
from pyorbslam_tpu_torch.utils.metrics import ate_rmse

SPAN = 100   # frames of each progress block and of the two rate spans


def peak_mb(device: torch.device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**20


def span_rates(stamps, t0: float, span: int = SPAN) -> tuple:
    """Frames/s over the first and over the last ``span`` frames (all of
    them when the run is shorter); ``stamps[i]`` is the host time at which
    frame ``i`` had been fed."""
    n = len(stamps)
    k = min(span, n)
    first = k / (stamps[k - 1] - t0)
    start = stamps[n - k - 1] if n > k else t0
    return first, k / (stamps[-1] - start)


def scale_config(stream, width: int, height: int, features: int) -> SlamConfig:
    return SlamConfig(
        camera=CameraConfig(
            fx=float(stream.K[0, 0]), fy=float(stream.K[1, 1]),
            cx=float(stream.K[0, 2]), cy=float(stream.K[1, 2]),
            width=width, height=height, bf=stream.bf, th_depth=40.0),
        orb=OrbConfig(n_features=features),
    )


def progress(system, done: int, n: int, t0: float, device) -> None:
    ks = system.map.keyframes
    lc = system.loop_closer
    mem = peak_mb(device)
    print(f"frame {done}/{n}: kfs={int(ks.alive[:ks.n].sum())}/{ks.n} "
          f"lms={int(system.map.landmarks.alive.sum())} "
          f"loops={lc.n_loops_closed if lc else 0} state={system.state} "
          f"elapsed={time.perf_counter() - t0:.1f}s"
          + (f" peak_device_mb={mem:.1f}" if mem is not None else ""),
          flush=True)
    stages = sorted(system.times.items(), key=lambda kv: -kv[1])[:6]
    print("  stages: " + "  ".join(
        f"{k}={v:.1f}s/{system.time_counts[k]}" for k, v in stages), flush=True)
    if lc is not None and lc.times:
        print("  loop:   " + "  ".join(
            f"{k}={v:.1f}s" for k, v in sorted(
                lc.times.items(), key=lambda kv: -kv[1])), flush=True)
    if system.map.times:
        print("  map:    " + "  ".join(
            f"{k}={v:.1f}s" for k, v in sorted(
                system.map.times.items(), key=lambda kv: -kv[1])[:6]), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--laps", type=float, default=2.2)
    ap.add_argument("--radius", type=float, default=60.0)
    ap.add_argument("--window", type=int, default=0,
                    help="0 = pipelined per-frame schedule; W = window_feed "
                         "in windows of W frames")
    ap.add_argument("--scene", default="corridor", choices=["corridor", "interior"],
                    help="interior = pillar rings inside the stereo depth "
                         "gate (the drift-then-repair world)")
    ap.add_argument("--no-loop", action="store_true",
                    help="disable loop closing (odometry-drift ablation)")
    ap.add_argument("--render-backend", default="numpy", choices=["numpy", "torch"],
                    help="torch = io/render_torch.py on --device")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every step (default: cuda)")
    ap.add_argument("--cache-dir", default=None,
                    help="per-frame stream cache (npz); none by default")
    args = ap.parse_args(argv)
    device = device_of(args.device)

    stream = SyntheticStream(
        n_frames=args.frames, width=args.width, height=args.height,
        trajectory="loop", loop_radius=args.radius, laps=args.laps,
        scene=args.scene, render_backend=args.render_backend,
        render_device=str(device), cache_dir=args.cache_dir)
    cfg = scale_config(stream, args.width, args.height, args.features)
    W = args.window
    n = args.frames - (args.frames % W if W else 0)

    t_render = time.perf_counter()
    frames = [stream.frame(i) for i in range(n)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    render_s = time.perf_counter() - t_render

    system = System(cfg, device, enable_loop_closing=not args.no_loop)
    stamps = []
    t0 = time.perf_counter()
    if W == 0:
        for i, (left, right) in enumerate(frames):
            system.track_stereo_async(left, right, stream.timestamps[i])
            stamps.append(time.perf_counter())
            if (i + 1) % SPAN == 0:
                progress(system, i + 1, n, t0, device)
        system.flush_async()
    else:
        for w0 in range(0, n, W):
            pairs = frames[w0: w0 + W]
            system.window_feed([p[0] for p in pairs], [p[1] for p in pairs],
                               stream.timestamps[w0: w0 + W])
            stamps += [time.perf_counter()] * W
            if (w0 + W) % SPAN < W:
                progress(system, w0 + W, n, t0, device)
        system.window_flush()
    system.shutdown()
    stamps[-1] = time.perf_counter()
    slam_s = stamps[-1] - t0
    first, last = span_rates(stamps, t0)

    est_wc = np.linalg.inv(system.corrected_trajectory().astype(np.float64))
    gt = stream.poses_wc[:n]
    ks, lc = system.map.keyframes, system.loop_closer
    print(json.dumps({
        "metric": "scale_run",
        "frames": n, "fps": n / slam_s, "ate_rmse_m": ate_rmse(est_wc, gt),
        "track_len_m": float(np.linalg.norm(
            np.diff(gt[:, :3, 3], axis=0), axis=1).sum()),
        "keyframes_alive": int(ks.alive[: ks.n].sum()),
        "keyframes_total": int(ks.n),
        "landmarks": int(system.map.landmarks.alive.sum()),
        "loops_closed": lc.n_loops_closed if lc else 0,
        "loops_rejected": lc.n_loops_rejected if lc else 0,
        "loops_fused": lc.n_loops_fused if lc else 0,
        "ba_rejected_writebacks": int(
            system.map.counters.get("ba.rejected_writebacks", 0)),
        "render_s": render_s, "slam_s": slam_s,
        "scene": args.scene, "loop_closing": not args.no_loop,
        "render_backend": args.render_backend,
        "backend": device.type,
        "device": device_line(device),
        "peak_device_mb": peak_mb(device),
        "frames_per_s_first_100": first, "frames_per_s_last_100": last,
        "stage_s": dict(system.times),
        "loop_s": dict(lc.times) if lc else {},
        "map_s": dict(system.map.times),
    }))


if __name__ == "__main__":
    main()
