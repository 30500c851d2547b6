"""Where a frame of ``System.track_stereo`` goes on one NVIDIA GPU.

    python3 -m pyorbslam_tpu_torch.tools.profile_system [--frames 16] [--warm 8]
                                                        [--pipelined]

Runs the port's ``System`` (default configuration, loop closing on) over
the first frames of the 1241x376 / 2000-feature synthetic sequence that
``chip_smoke.py`` uses, twice:

1. **Stages.**  The device functions of a frame (``build_stereo_frame``,
   ``motion_track_step``, ``local_track_step``, ``pose_optimization``)
   and of a keyframe (``kf_snapshot``, ``maintenance_ring_step``,
   ``bundle_adjust_grid``) are wrapped so that each call is timed on the
   host clock between two ``torch.cuda.synchronize()``.  Frames after
   ``--warm`` count.  A stage's time holds the stages it calls
   (``pose_optimization`` runs inside the two track steps).
2. **Profiler.**  A fresh run; ``torch.profiler`` traces the frames after
   ``--warm``: kernel launches and device kernel time per frame, the ten
   kernels with the most device time, and the device's idle share
   (1 - kernel time / wall time of the window; the profiler slows the
   host, so the share is an upper bound).  With ``--pipelined`` this run
   goes through ``System.track_stereo_async``.

Prints the card's ``nvidia-smi`` name and power limit first and one JSON
object last.  It needs a CUDA device and fails without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time
from collections import defaultdict

import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.optim import ba, pose_opt
from pyorbslam_tpu_torch.slam import local_mapping, system, tracking
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls

WIDTH, HEIGHT, N_FEATURES = 1241, 376, 2000
STAGES = (
    (tracking, "build_stereo_frame"), (tracking, "motion_track_step"),
    (tracking, "local_track_step"), (pose_opt, "pose_optimization"),
    (system, "kf_snapshot"), (local_mapping, "maintenance_ring_step"),
    (ba, "bundle_adjust_grid"),
)


def make_run(n_frames: int):
    seq = generate_sequence(n_frames=n_frames, width=WIDTH, height=HEIGHT,
                            trajectory="straight", speed=0.8, seed=3)
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=WIDTH, height=HEIGHT, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=N_FEATURES))
    return seq, cfg


def new_system(cfg, device):
    return system.System(cfg, device, keyframe_capacity=256)


@contextlib.contextmanager
def timed_stages(totals: dict, counts: dict, enabled: list):
    """Replace each stage function by a synced, timed wrapper in the
    module that looks it up; restore on exit."""
    saved = []

    def wrap(name, fn):
        def timed(*args, **kwargs):
            if not enabled[0]:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            counts[name] += 1
            return out
        return timed

    try:
        for module, name in STAGES:
            fn = getattr(module, name)
            saved.append((module, name, fn))
            setattr(module, name, wrap(name, fn))
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def stage_pass(seq, cfg, device, warm: int) -> dict:
    totals, counts, enabled = defaultdict(float), defaultdict(int), [False]
    sysm = new_system(cfg, device)
    n = seq.left.shape[0]
    with timed_stages(totals, counts, enabled):
        for i in range(n):
            if i == warm:
                enabled[0] = True
                torch.cuda.synchronize()
                kfs0, t0 = sysm.map.keyframes.n, time.perf_counter()
            sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    frames = n - warm
    out = dict(frames=frames, keyframes=sysm.map.keyframes.n - kfs0,
               ms_per_frame=1e3 * wall / frames,
               states=sorted(set(s["state"] for s in sysm.stats)))
    for name in totals:
        out[name] = dict(calls=counts[name],
                         ms_per_call=1e3 * totals[name] / counts[name],
                         ms_per_frame=1e3 * totals[name] / frames)
    return out


def device_time_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise RuntimeError("this torch.profiler reports no device time per event")


def profiler_pass(seq, cfg, device, warm: int, pipelined: bool = False) -> dict:
    """``torch.profiler`` over frames ``warm``.. of a ``System`` run; with
    ``pipelined`` through ``track_stereo_async`` (flushed inside the
    traced window, so every traced frame's work is in it)."""
    from torch.profiler import ProfilerActivity, profile

    sysm = new_system(cfg, device)
    track = sysm.track_stereo_async if pipelined else sysm.track_stereo
    n = seq.left.shape[0]
    for i in range(warm):
        track(seq.left[i], seq.right[i], seq.timestamps[i])
    sysm.flush_async()
    torch.cuda.synchronize()
    kfs0, t0 = sysm.map.keyframes.n, time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(warm, n):
            track(seq.left[i], seq.right[i], seq.timestamps[i])
        sysm.flush_async()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frames = n - warm
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device event")
    launches = sum(e.count for e in kernels)
    kernel_ms = sum(device_time_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=device_time_us, reverse=True)[:10]
    return dict(
        frames=frames, keyframes=sysm.map.keyframes.n - kfs0,
        wall_ms_per_frame=1e3 * wall / frames,
        launches_per_frame=launches / frames,
        kernel_ms_per_frame=kernel_ms / frames,
        idle_share=1.0 - kernel_ms / (1e3 * wall),
        top_kernels=[dict(name=e.key[:80], launches_per_frame=e.count / frames,
                          ms_per_frame=device_time_us(e) / 1e3 / frames)
                     for e in top])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--pipelined", action="store_true",
                    help="trace System.track_stereo_async instead of "
                         "track_stereo (the stage times stay those of the "
                         "synchronous path: a synced stage cannot pipeline)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_system needs a CUDA device; none is available")
    if not 0 < args.warm < args.frames:
        raise SystemExit("--warm must lie inside --frames")
    device = torch.device("cuda", 0)
    use_f32_matmuls()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    seq, cfg = make_run(args.frames)
    stages = stage_pass(seq, cfg, device, args.warm)
    print(f"stages over frames {args.warm}-{args.frames - 1} "
          f"({stages['keyframes']} keyframes): "
          f"{stages['ms_per_frame']:.1f} ms/frame with synced stages", flush=True)
    for _, name in STAGES:
        if name in stages:
            s = stages[name]
            print(f"  {name}: {s['ms_per_call']:.2f} ms/call x {s['calls']} "
                  f"= {s['ms_per_frame']:.2f} ms/frame", flush=True)
    prof = profiler_pass(seq, cfg, device, args.warm, args.pipelined)
    print(f"profiler over the same frames"
          f"{' (pipelined schedule)' if args.pipelined else ''}: "
          f"{prof['launches_per_frame']:.0f} "
          f"launches/frame, {prof['kernel_ms_per_frame']:.2f} ms device kernel "
          f"time/frame, {prof['wall_ms_per_frame']:.1f} ms wall/frame, idle "
          f"share {prof['idle_share']:.4f}", flush=True)
    for k in prof["top_kernels"]:
        print(f"  {k['ms_per_frame']:.3f} ms/frame  {k['launches_per_frame']:.0f}x  "
              f"{k['name']}", flush=True)
    print(json.dumps(dict(card=smi, device=torch.cuda.get_device_name(0),
                          stages=stages, profiler=prof)))


if __name__ == "__main__":
    main()
