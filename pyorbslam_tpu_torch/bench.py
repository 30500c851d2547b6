"""Benchmark of the port: tracked frames/s on one card over a synthetic
KITTI-resolution stereo sequence at the reference operating point (2000
ORB features, 8 levels).  The counterpart of the repository's ``bench.py``:
the same configurations, the same environment variables, the same record.

    python3 -m pyorbslam_tpu_torch.bench [--device cuda]

``BENCH_CONFIG`` chooses what runs:

* ``""`` (the default): the full pipeline (tracking, local mapping, local
  BA, loop closing) in the pipelined per-frame schedule
  (``System.track_stereo_async``), with the tracking-only number of the
  motion-tracking program attached as ``tracking_only_fps``;
* ``perframe`` and ``pipeline``: the full pipeline, synchronous per-frame
  schedule (``System.track_stereo``);
* ``highdensity_pipeline``: the same with 8000 ORB features;
* ``pipeline_window`` / ``pipeline_pipelined``: windows of
  ``BENCH_WINDOW`` frames (default 8), ``track_stereo_window`` /
  ``window_feed`` + ``window_flush``;
* ``tracking`` / ``highdensity``: only the motion-tracking program
  (frame build, unprojection of the previous frame's stereo points,
  ``motion_track_step`` with a constant-velocity seed), at 2000 / 8000
  features.  ``BENCH_MODE=scan`` (default) runs the sequence as one loop
  on the device with the images uploaded beforehand and no host read
  inside; ``stream`` makes one call a frame and reads the inlier counts
  once at the end.  In PyTorch both are eager loops: their time is the
  host's enqueue of the step's launches, not one compiled program.

``BENCH_FRAMES`` sets the sequence length (34 for the tracking program,
66 for the full pipeline).  The full pipeline runs one warm pass and then
three timed passes, each on a fresh ``System``, and reports the median.
Prints ONE JSON line with the keys of the repository's ``bench.py``;
``device`` is the card's ``nvidia-smi`` name and power limit (``cpu``
with ``--device cpu``).  ``vs_baseline`` divides by
``baseline_measured.json``'s ``reference_fps``: the C++/Python
reference's frames/s on another machine's CPU (its ``hardware``), not a
number of the card's.  Nothing falls back: with ``--device cuda`` and no
CUDA device the command fails.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.geometry import se3
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.slam.frame import StereoFrame, build_stereo_frame, unproject
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.slam.tracking import motion_track_step
from pyorbslam_tpu_torch.utils.device import device_line, device_of
from pyorbslam_tpu_torch.utils.host_read import upload
from pyorbslam_tpu_torch.utils.metrics import ate_rmse
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_DIR = os.path.join(REPO, "tests", "_data")
BASELINE_PATH = os.path.join(REPO, "baseline_measured.json")
WIDTH, HEIGHT = 1241, 376
N_FEATURES = 2000
DENSITY = 4                 # highdensity: 4x the features (8000)
TRACKING_FRAMES, PIPELINE_FRAMES = 34, 66

# BENCH_CONFIG -> bench_full_pipeline's schedule, as bench.py:37-62 maps it
FULL_CONFIGS = {
    "": dict(async_mode=True),
    "perframe": dict(),
    "pipeline": dict(),
    "highdensity_pipeline": dict(dense=True),
    "pipeline_window": dict(windowed=True),
    "pipeline_pipelined": dict(windowed=True, pipelined=True),
}
# BENCH_CONFIG -> the tracking program at high density or not
TRACKING_CONFIGS = {"tracking": False, "highdensity": True}
CONFIGS = tuple(FULL_CONFIGS) + tuple(TRACKING_CONFIGS)


class TrackingRun(NamedTuple):
    """The timed pass of the tracking program."""

    fps: float
    poses: np.ndarray       # (n, 4, 4) Tcw of the frames after the first two
    n_inliers: np.ndarray   # (n,) pose-optimizer inliers of those frames


def bench_sequence(n_frames: int, n_features: int, seq=None):
    """bench.py's sequence (rendered, or read from the cache in
    ``tests/_data/``) and its ``SlamConfig``; ``seq`` is used as given
    instead (its first ``n_frames`` frames)."""
    if seq is None:
        seq = generate_sequence(
            n_frames=n_frames, width=WIDTH, height=HEIGHT,
            trajectory="straight", speed=0.8, seed=3, cache_dir=CACHE_DIR)
    if len(seq.timestamps) < n_frames:
        raise ValueError(f"{n_frames} frames asked of a "
                         f"{len(seq.timestamps)}-frame sequence")
    h, w = seq.left.shape[1:]
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=w, height=h, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=n_features),
    )
    return seq, cfg


def tracking_step(left, right, prev: StereoFrame, Tlw, Tllw, cfg: SlamConfig):
    """One tracked frame of the tracking program: stereo ORB extraction and
    matching, the previous frame's stereo points in the world, the
    constant-velocity prediction, projection matching and the 4x10 LM pose
    optimization (bench.py:104-117).  Returns (frame, Tcw, n_inliers), all
    on the device."""
    frame = build_stereo_frame(left, right, cfg)
    q_pos = unproject(prev, cfg, se3.inverse(Tlw))
    vel = Tlw @ se3.inverse(Tllw)
    res = motion_track_step(
        frame, q_pos, prev.desc, prev.angle, prev.octave, prev.depth > 0,
        vel @ Tlw, Tlw, cfg)
    return frame, res.Tcw, res.n_inliers


def empty_frame(cfg: SlamConfig, device) -> StereoFrame:
    """The bootstrap's previous frame: no valid feature, no stereo point
    (the first step's tracking result is discarded)."""
    n = cfg.orb.max_keypoints

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return StereoFrame(
        xy=zeros(n, 2), response=zeros(n), angle=zeros(n),
        octave=zeros(n, dtype=torch.int32), desc=zeros(n, 8, dtype=torch.int32),
        desc_bits=zeros(n, 256, dtype=torch.int8), valid=zeros(n, dtype=torch.bool),
        u_right=zeros(n) - 1.0, depth=zeros(n) - 1.0)


def track_scan(seq_lr: torch.Tensor, frame0: StereoFrame, Tlw0, Tllw0,
               cfg: SlamConfig):
    """The tracking program over stacked stereo pairs ``seq_lr`` (N, 2, H,
    W), carrying (previous frame, pose, previous pose) from step to step
    on the device, as bench.py's ``lax.scan`` does.  Nothing is read back:
    returns the (N, 4, 4) poses and (N,) inlier counts on the device."""
    carry = (frame0, Tlw0, Tllw0)
    poses, n_ins = [], []
    for lr in seq_lr:
        prev, Tlw, Tllw = carry
        frame, Tcw, n_in = tracking_step(lr[0], lr[1], prev, Tlw, Tllw, cfg)
        poses.append(Tcw)
        n_ins.append(n_in)
        carry = (frame, Tcw, Tlw)
    return torch.stack(poses), torch.stack(n_ins)


def _finish(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_tracking_scan(device, seq, cfg: SlamConfig, n_frames: int,
                        mode: str = "scan") -> TrackingRun:
    """Frames/s of the tracking program over frames 2..n-1 of ``seq``
    (bench.py:65-216).  Frames 0 and 1 bootstrap the chain; ``scan`` runs
    the chain once untimed and then once timed, ``stream`` once timed."""
    if mode not in ("scan", "stream"):
        raise ValueError(f"BENCH_MODE {mode!r}: scan or stream")
    use_f32_matmuls()
    frames = [(upload(seq.left[i], device), upload(seq.right[i], device))
              for i in range(n_frames)]
    eye = torch.eye(4, dtype=torch.float32, device=device)
    # frames 0 and 1 bootstrap the chain, each read back (bench.py's warm-up)
    frame, _, n_in = tracking_step(*frames[0], empty_frame(cfg, device),
                                   eye, eye, cfg)
    int(n_in)
    frame, Tcw, n_in = tracking_step(*frames[1], frame, eye, eye, cfg)
    int(n_in)

    if mode == "scan":
        seq_lr = torch.stack([torch.stack(lr) for lr in frames[2:]])
        track_scan(seq_lr, frame, Tcw, eye, cfg)       # warm pass
        _finish(device)
        t0 = time.perf_counter()
        poses, n_ins = track_scan(seq_lr, frame, Tcw, eye, cfg)
        _finish(device)
        dt = time.perf_counter() - t0
    else:
        _finish(device)
        t0 = time.perf_counter()
        prev, Tlw, Tllw = frame, Tcw, eye
        pose_list, inlier_list = [], []
        for left, right in frames[2:]:
            frame, Tcw, n_in = tracking_step(left, right, prev, Tlw, Tllw, cfg)
            pose_list.append(Tcw)
            inlier_list.append(n_in)
            prev, Tllw, Tlw = frame, Tlw, Tcw
        poses, n_ins = torch.stack(pose_list), torch.stack(inlier_list)
        _finish(device)
        dt = time.perf_counter() - t0
    n_ins = n_ins.cpu().numpy()
    return TrackingRun(fps=len(n_ins) / dt, poses=poses.cpu().numpy(),
                       n_inliers=n_ins)


def _baseline(full: bool):
    """(reference frames/s, its source), as bench.py reads them."""
    if not os.path.exists(BASELINE_PATH):
        return 10.0, "upstream-cpp-estimate"
    with open(BASELINE_PATH) as f:
        bl = json.load(f)
    if full and "scope" in bl:
        return float(bl["reference_fps"]), "measured-" + bl["scope"].split(" ")[0]
    return float(bl["reference_fps"]), "measured"


def tracking_record(run: TrackingRun, cfg: SlamConfig, mode: str, device) -> dict:
    baseline_fps, baseline_src = _baseline(full=False)
    return {
        "metric": "tracked_frames_per_s_per_chip",
        "value": round(run.fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(run.fps / baseline_fps, 2),
        "baseline_fps": baseline_fps,
        "baseline_source": baseline_src,
        "config": f"{cfg.camera.width}x{cfg.camera.height} stereo, "
                  f"{cfg.orb.n_features} ORB features, {cfg.orb.n_levels} "
                  "levels, motion tracking",
        "mode": mode,
        "n_frames": len(run.n_inliers),
        "device": device_line(device),
    }


def bench_full_pipeline(device, seq, cfg: SlamConfig, n_frames: int,
                        window: int = 0, pipelined: bool = False,
                        async_mode: bool = False, tracking_fps=None,
                        passes: int = 3):
    """Full-pipeline frames/s (bench.py:219-353): one warm pass, then
    ``passes`` timed passes, each on a fresh ``System``; the record of the
    median pass and its ``System``.  ``window`` > 0 tracks windows of that
    many frames (``track_stereo_window``, or with ``pipelined``
    ``window_feed`` / ``window_flush``); ``async_mode`` runs
    ``track_stereo_async`` with the next frame's upload enqueued before
    the current frame is fed."""
    n = n_frames - (n_frames % window if window else 0)

    def run():
        sysm = System(cfg, device)
        if window and pipelined:
            for w0 in range(0, n, window):
                sysm.window_feed(seq.left[w0: w0 + window], seq.right[w0: w0 + window],
                                 seq.timestamps[w0: w0 + window])
            sysm.window_flush()
        elif window:
            for w0 in range(0, n, window):
                sysm.track_stereo_window(
                    seq.left[w0: w0 + window], seq.right[w0: w0 + window],
                    seq.timestamps[w0: w0 + window])
        elif async_mode:
            # double-buffered sensor upload: frame i+1's images are on their
            # way (pinned, non-blocking) while frame i is processed
            nxt = (upload(seq.left[0], device), upload(seq.right[0], device))
            for i in range(n):
                cur = nxt
                if i + 1 < n:
                    nxt = (upload(seq.left[i + 1], device),
                           upload(seq.right[i + 1], device))
                sysm.track_stereo_async(cur[0], cur[1], seq.timestamps[i])
            sysm.flush_async()
        else:
            for i in range(n):
                sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        _finish(device)
        if len(sysm.trajectory) != n:
            raise RuntimeError(f"{len(sysm.trajectory)} poses for {n} frames")
        return sysm

    run()                           # warm pass
    results = []
    for _ in range(passes):
        t0 = time.perf_counter()
        sysm = run()
        dt = time.perf_counter() - t0
        est = np.linalg.inv(sysm.corrected_trajectory().astype(np.float64))
        results.append((n / dt, float(ate_rmse(est, seq.poses_wc[: len(est)])), sysm))
    results.sort(key=lambda r: r[0])
    fps, ate, sysm = results[len(results) // 2]

    baseline_fps, baseline_src = _baseline(full=True)
    mode = ("pipelined" if pipelined else "window") if window else \
        ("async" if async_mode else "per-frame")
    rec = {
        "metric": "full_pipeline_frames_per_s_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / baseline_fps, 2),
        "baseline_fps": baseline_fps,
        "baseline_source": baseline_src,
        "config": f"{cfg.camera.width}x{cfg.camera.height} stereo, "
                  f"{cfg.orb.n_features} ORB features, {cfg.orb.n_levels} "
                  "levels, tracking + local mapping + local BA + loop closing"
                  + (f", window={window} ({mode})" if window
                     else f", {mode} schedule"),
        "n_frames": n,
        "n_keyframes": int(sysm.map.keyframes.n),
        "ate_rmse_m": round(ate, 4),
        "fps_passes": [round(r[0], 2) for r in results],
        "device": device_line(device),
    }
    if tracking_fps is not None:
        rec["tracking_only_fps"] = round(tracking_fps, 2)
    rec["stages_s"] = {
        k: [round(v, 3), sysm.time_counts[k]]
        for k, v in sorted(sysm.times.items(), key=lambda kv: -kv[1])
    }
    rec["ba_stages_s"] = {
        k: round(v, 3)
        for k, v in sorted(sysm.map.times.items(), key=lambda kv: -kv[1])
    }
    rec["ba_counters"] = dict(sysm.map.counters)
    # the JAX System's events are schedule strings only; the port's log
    # also holds (stage, keyframe, info) tuples, which are not counted
    rec["schedule_events"] = dict(Counter(
        e for e in sysm.events if isinstance(e, str)))
    return rec, sysm


def run_config(config: str, device, *, n_frames=None, mode: str = "scan",
               window: int = 8, passes: int = 3, seq=None):
    """One ``BENCH_CONFIG``: returns (record, detail), the detail being the
    timed ``System`` of the full pipeline or the :class:`TrackingRun`.
    ``n_frames`` None takes bench.py's lengths; ``seq`` replaces the
    rendered sequence (the tests pass a cached one)."""
    device = torch.device(device)
    if config in TRACKING_CONFIGS:
        nf = N_FEATURES * (DENSITY if TRACKING_CONFIGS[config] else 1)
        n = n_frames or TRACKING_FRAMES
        tseq, cfg = bench_sequence(n, nf, seq)
        run = bench_tracking_scan(device, tseq, cfg, n, mode)
        return tracking_record(run, cfg, mode, device), run
    if config not in FULL_CONFIGS:
        raise ValueError(f"BENCH_CONFIG {config!r}: one of {CONFIGS}")
    kind = FULL_CONFIGS[config]
    tracking_fps = None
    if kind.get("async_mode"):
        n = n_frames or TRACKING_FRAMES
        tseq, cfg = bench_sequence(n, N_FEATURES, seq)
        tracking_fps = bench_tracking_scan(device, tseq, cfg, n, mode).fps
    n = n_frames or PIPELINE_FRAMES
    nf = N_FEATURES * (DENSITY if kind.get("dense") else 1)
    fseq, cfg = bench_sequence(n, nf, seq)
    return bench_full_pipeline(
        device, fseq, cfg, n, window=window if kind.get("windowed") else 0,
        pipelined=kind.get("pipelined", False),
        async_mode=kind.get("async_mode", False), tracking_fps=tracking_fps,
        passes=passes)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device of every step (default: cuda)")
    args = ap.parse_args(argv)
    device = device_of(args.device)
    frames = os.environ.get("BENCH_FRAMES")
    rec, _ = run_config(
        os.environ.get("BENCH_CONFIG", ""), device,
        n_frames=int(frames) if frames else None,
        mode=os.environ.get("BENCH_MODE", "scan"),
        window=int(os.environ.get("BENCH_WINDOW", "8")))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
