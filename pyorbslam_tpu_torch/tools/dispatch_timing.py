"""Host time of the pipelined schedule's dispatch stages on one GPU.

    python3 pyorbslam_tpu_torch/tools/dispatch_timing.py [--cache-dir DIR]
        [--frames 34] [--level-frames 12]

Runs ``System.track_stereo_async`` + ``flush_async`` over the 1241x376 /
2000-feature straight synthetic sequence of ``chip_smoke.py`` twice, with
loop closing off so that any tree of the port runs it: the default
(atlas) configuration over ``--frames`` frames and the per-level
configuration (``use_atlas=False``) over ``--level-frames``.  Prints one
JSON line: the card's ``nvidia-smi`` name and power limit, the package
directory it ran, frames/s of both runs (first frame excluded) and the
mean host milliseconds of ``async.dispatch``, ``kf.maintain_dispatch``
and ``kf.ba_dispatch``: the stages a synchronizing call inside a dispatch
lengthens.

The package is imported from ``sys.path``: run the script by its path
with ``PYTHONPATH`` naming a checkout to time that checkout's port (for
example a parent commit unpacked beside the tree), and two checkouts in
one call to compare them on one card.  ``--cache-dir`` keeps the
rendered sequence between runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.slam.system import System

STAGES = ("async.dispatch", "kf.maintain_dispatch", "kf.ba_dispatch")


def run(seq, cfg, device, n_frames: int) -> dict:
    system = System(cfg, device, keyframe_capacity=256,
                    enable_loop_closing=False)
    system.track_stereo_async(seq.left[0], seq.right[0], seq.timestamps[0])
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for i in range(1, n_frames):
        system.track_stereo_async(seq.left[i], seq.right[i], seq.timestamps[i])
    system.flush_async()
    system.shutdown()
    elapsed = time.perf_counter() - t0
    out = dict(fps=(n_frames - 1) / elapsed, keyframes=system.map.keyframes.n)
    for label in STAGES:
        k = system.time_counts[label]
        out[label + "_ms"] = 1e3 * system.times[label] / k if k else None
        out[label + "_calls"] = k
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--frames", type=int, default=34)
    ap.add_argument("--level-frames", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dispatch_timing.py needs a CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    seq = generate_sequence(n_frames=max(args.frames, args.level_frames),
                            width=1241, height=376, trajectory="straight",
                            speed=0.8, seed=3, cache_dir=args.cache_dir)
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=1241, height=376, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=2000))
    levels = dataclasses.replace(
        cfg, orb=dataclasses.replace(cfg.orb, use_atlas=False))
    import pyorbslam_tpu_torch
    print(json.dumps(dict(
        card=smi,
        package=os.path.dirname(os.path.abspath(pyorbslam_tpu_torch.__file__)),
        atlas=run(seq, cfg, device, args.frames),
        per_level=run(seq, levels, device, args.level_frames))))


if __name__ == "__main__":
    main()
