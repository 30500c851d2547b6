#!/usr/bin/env python3
"""Drive the PyTorch port's per-frame path on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device and build: refuses to run without CUDA, turns TF32 off, prints
   the card's name and power limit, builds the CUDA kernels from
   ``pyorbslam_tpu_torch/csrc`` and prints the build time.
2. Kernels against their plain twins at the path's own shapes: the FAST
   kernel on the 4224x1279 atlas canvas of a 1241x376 stereo frame (max
   |diff| must be 0) and the rBRIEF kernel on that frame's 4000 kept
   keypoints (every word equal); each timed with CUDA events beside its
   twin.  The whole GPU frame is also held against the same frame built
   on the CPU, where the twins run.
3. The slice: ``Tracker`` over the 34-frame 1241x376 synthetic sequence
   with 2000 ORB features and 8 levels; both kernels must have launched
   at least once per frame, every pose must be finite, drift (ATE over
   track length) under 2.5% and at most 3 weak frames.
4. The fused per-frame program: ``fused_track_chain_step`` over the same
   frames, chained frame to frame, against a landmark mirror frozen after
   the tracker's first frame.

Any failed check raises, so the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
is the card's ``nvidia-smi`` name and power limit, and the one before
that the per-kernel JSON record.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.ops import atlas, fast, kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops
from pyorbslam_tpu_torch.ops.hamming import unpack_bits
from pyorbslam_tpu_torch.slam.frame import build_stereo_frame
from pyorbslam_tpu_torch.slam.tracking import Tracker, fused_track_chain_step
from pyorbslam_tpu_torch.utils.metrics import ate_rmse
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls

N_FRAMES = 34
WIDTH, HEIGHT = 1241, 376
N_FEATURES = 2000
MAX_DRIFT = 0.025
MAX_WEAK = 3
TIMING_REPS = 25


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_sequence():
    seq = generate_sequence(n_frames=N_FRAMES, width=WIDTH, height=HEIGHT,
                            trajectory="straight", speed=0.8, seed=3)
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=WIDTH, height=HEIGHT, bf=seq.bf, th_depth=40.0,
        ),
        orb=OrbConfig(n_features=N_FEATURES),
    )
    return seq, cfg


def time_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median device time of one call, CUDA events around each call,
    after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernels(seq, cfg, device) -> list:
    """Phase 2: each kernel against its twin on the frame's own tensors."""
    orb = cfg.orb
    left = torch.as_tensor(seq.left[0], device=device).to(torch.float32)
    right = torch.as_tensor(seq.right[0], device=device).to(torch.float32)
    levels_l = pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels)
    levels_r = pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels)
    kp = atlas.atlas_keypoints(left, right, orb, levels_l, levels_r)
    canvas = kp.canvas
    log(f"canvas {tuple(canvas.shape)}, keypoint slots {kp.cxy.shape[0]}, "
        f"valid {int(kp.valid.sum())}")

    score_k = kernels.fast_score_map(canvas)
    score_t = fast.fast_score_map(canvas)
    torch.cuda.synchronize()
    fast_err = float((score_k - score_t).abs().max())
    require(fast_err == 0.0, f"fast_score kernel differs from its twin: {fast_err}")
    fast_ms = time_ms(lambda: kernels.fast_score_map(canvas))
    fast_plain_ms = time_ms(lambda: fast.fast_score_map(canvas))

    cos, sin = desc_ops.cos_sin(kp.angle)
    cos, sin = cos.contiguous(), sin.contiguous()
    desc_k = kernels.brief_descriptors_canvas(kp.blur, kp.cxy, kp.angle)
    desc_t = kernels.brief_descriptors_canvas_ref(kp.blur, kp.cxy, kp.angle)
    torch.cuda.synchronize()
    bit_diff = unpack_bits(desc_k) != unpack_bits(desc_t)
    brief_err = float(bit_diff.to(torch.float32).max())
    require(torch.equal(desc_k, desc_t),
            f"brief_canvas kernel differs from its twin in "
            f"{int((desc_k != desc_t).sum())} of {desc_k.numel()} words")
    brief_ms = time_ms(lambda: kernels.brief_canvas_kernel(kp.blur, kp.cxy, cos, sin))
    brief_plain_ms = time_ms(lambda: kernels.brief_canvas_gather(kp.blur, kp.cxy, cos, sin))
    log(f"fast_score   kernel {fast_ms:.4f} ms  twin {fast_plain_ms:.4f} ms  "
        f"max|diff| {fast_err}")
    log(f"brief_canvas kernel {brief_ms:.4f} ms  twin {brief_plain_ms:.4f} ms  "
        f"words {desc_k.shape[0]}x{desc_k.shape[1]} equal")
    return [
        dict(name=kernels.FAST_SCORE.name, route="cuda",
             source=kernels.FAST_SCORE.source, replaces=kernels.FAST_SCORE.replaces,
             max_abs_err=fast_err, ms=fast_ms, plain_ms=fast_plain_ms),
        dict(name=kernels.BRIEF_CANVAS.name, route="cuda",
             source=kernels.BRIEF_CANVAS.source,
             replaces=kernels.BRIEF_CANVAS.replaces,
             max_abs_err=brief_err, ms=brief_ms, plain_ms=brief_plain_ms),
    ]


def check_frame_against_cpu(seq, cfg, device) -> None:
    """The whole frame on the GPU against the same frame on the CPU (where
    the twins run): same keypoints, near-identical descriptors.  Column
    cumulative sums accumulate in another order on the two devices, so a
    few IC angles, and through them a few descriptor bits, may differ."""
    gpu = convert.frame_to_numpy(build_stereo_frame(
        torch.as_tensor(seq.left[0], device=device),
        torch.as_tensor(seq.right[0], device=device), cfg))
    cpu = convert.frame_to_numpy(build_stereo_frame(
        torch.as_tensor(seq.left[0]), torch.as_tensor(seq.right[0]), cfg))
    for name in ("xy", "octave", "valid"):
        require(np.array_equal(gpu[name], cpu[name]),
                f"GPU and CPU frames differ in {name}")
    bits = np.unpackbits((gpu["desc"] ^ cpu["desc"]).view(np.uint8)).sum()
    agree = 1.0 - bits / (gpu["desc"].size * 32)
    matched_g, matched_c = gpu["depth"] > 0, cpu["depth"] > 0
    same_matched = float((matched_g == matched_c).mean())
    log(f"frame GPU vs CPU: keypoints equal, descriptor bits agree "
        f"{agree:.6f}, stereo-matched flags agree {same_matched:.6f}, "
        f"valid {int(gpu['valid'].sum())}, matched {int(matched_g.sum())}")
    require(agree >= 0.999, f"descriptor bit agreement {agree}")
    require(same_matched >= 0.99, f"stereo-matched agreement {same_matched}")


def drift_of(poses_cw: list, seq, n: int) -> tuple:
    est_wc = np.linalg.inv(np.stack(poses_cw).astype(np.float64))
    gt = seq.poses_wc[:n]
    length = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum()
    ate = ate_rmse(est_wc, gt)
    return ate, ate / length, length


def run_tracker(seq, cfg, device) -> dict:
    """Phase 3: the Tracker over the sequence; snapshot of the map after
    its first frame for phase 4."""
    tracker = Tracker(cfg, device)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tracker.track(seq.left[0], seq.right[0], seq.timestamps[0])
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    require(tracker.state == "OK", "tracker did not initialize on frame 0")
    snapshot = dict(
        mirror=convert.landmark_mirror(tracker.landmarks, device),
        q_lm=torch.as_tensor(tracker.last_assign, device=device),
        frame=tracker.last_frame,
        local_ids=np.concatenate(tracker.kf_groups).astype(np.int32),
    )
    t1 = time.perf_counter()
    for i in range(1, N_FRAMES):
        tracker.track(seq.left[i], seq.right[i], seq.timestamps[i])
    torch.cuda.synchronize()
    t_rest = time.perf_counter() - t1
    counts = kernels.launch_counts()

    poses = tracker.trajectory
    require(len(poses) == N_FRAMES, "a frame was not tracked")
    require(all(np.isfinite(p).all() for p in poses), "non-finite pose")
    ate, drift, length = drift_of(poses, seq, N_FRAMES)
    weak = sum(1 for s in tracker.stats if s["inliers"] < 20)
    fps = (N_FRAMES - 1) / t_rest
    log(f"Tracker: {N_FRAMES} frames, first {t_first:.3f} s, then {fps:.3f} "
        f"frames/s; ATE {ate:.4f} m over {length:.2f} m (drift "
        f"{100 * drift:.3f}%), weak frames {weak}, median inliers "
        f"{np.median([s['inliers'] for s in tracker.stats])}, landmarks "
        f"{tracker.landmarks.n}, launches {counts}")
    for name, n in counts.items():
        require(n >= N_FRAMES, f"{name} launched {n} times over {N_FRAMES} frames")
    require(drift < MAX_DRIFT, f"drift {drift:.4f} >= {MAX_DRIFT}")
    require(weak <= MAX_WEAK, f"{weak} weak frames")
    return dict(counts=counts, snapshot=snapshot, fps=fps)


def run_fused_chain(seq, cfg, device, snapshot) -> dict:
    """Phase 4: fused_track_chain_step frame after frame against the
    frozen mirror, each frame's carry feeding the next."""
    m = snapshot["mirror"]
    n_feat = cfg.orb.max_keypoints
    cap = cfg.tracking.max_local_points
    p_ids = np.full(cap, -1, np.int32)
    local = snapshot["local_ids"][-cap:]
    p_ids[: len(local)] = local
    p_ids = torch.as_tensor(p_ids, device=device)
    frame_prev, q_lm = snapshot["frame"], snapshot["q_lm"]
    Tcw = np.eye(4, dtype=np.float32)
    velocity = np.eye(4, dtype=np.float32)
    poses = [Tcw]
    min_matches = None
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(1, N_FRAMES):
        Tcw_pred = (velocity @ Tcw).astype(np.float32)
        row, frame_prev = fused_track_chain_step(
            torch.as_tensor(seq.left[i], device=device),
            torch.as_tensor(seq.right[i], device=device),
            m["pos"], m["desc"], m["normal"], m["dmin"], m["dmax"], m["alive"],
            frame_prev, q_lm,
            torch.as_tensor(Tcw_pred, device=device),
            torch.as_tensor(Tcw, device=device), p_ids, cfg,
        )
        q_lm = row[21: 21 + n_feat]
        host = row.cpu().numpy()
        n_matches = int(host[0])
        T_new = host[5:21].view(np.float32).reshape(4, 4).copy()
        require(np.isfinite(T_new).all(), f"non-finite pose at frame {i}")
        require(n_matches >= 20, f"{n_matches} matches at frame {i}")
        min_matches = n_matches if min_matches is None else min(min_matches, n_matches)
        velocity = (T_new @ np.linalg.inv(Tcw)).astype(np.float32)
        Tcw = T_new
        poses.append(Tcw)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    ate, drift, length = drift_of(poses, seq, N_FRAMES)
    fps = (N_FRAMES - 1) / elapsed
    log(f"fused_track_chain_step: {N_FRAMES - 1} frames at {fps:.3f} frames/s; "
        f"ATE {ate:.4f} m over {length:.2f} m (drift {100 * drift:.3f}%), "
        f"min matches {min_matches}, launches {counts}")
    for name, n in counts.items():
        require(n >= N_FRAMES - 1,
                f"{name} launched {n} times over {N_FRAMES - 1} fused frames")
    require(drift < MAX_DRIFT, f"fused drift {drift:.4f} >= {MAX_DRIFT}")
    return dict(counts=counts, fps=fps)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is available")
    device = torch.device("cuda", 0)
    use_f32_matmuls()
    smi = nvidia_smi_line()
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    build_logs = kernels.build_kernels()
    log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name, text in build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    seq, cfg = make_sequence()
    log(f"rendered {N_FRAMES} frames of {WIDTH}x{HEIGHT} in "
        f"{time.perf_counter() - t0:.1f} s")

    records = check_kernels(seq, cfg, device)
    check_frame_against_cpu(seq, cfg, device)
    tracked = run_tracker(seq, cfg, device)
    fused = run_fused_chain(seq, cfg, device, tracked["snapshot"])
    log(f"frames/s on the card: Tracker {tracked['fps']:.3f}, "
        f"fused_track_chain_step {fused['fps']:.3f}")

    for rec in records:
        rec["launches"] = tracked["counts"][rec["name"]]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
