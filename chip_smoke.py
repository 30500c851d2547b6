#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Device and build: refuses to run without CUDA, turns TF32 off, prints
   the card's name and power limit, builds the three CUDA kernels from
   ``pyorbslam_tpu_torch/csrc`` (one nvcc each, started together) and
   the native map core, and prints the build time.
2. Kernels against their plain twins at the paths' own shapes: the FAST
   kernel on the 4224x1279 atlas canvas of a 1241x376 stereo frame and on
   level 0 (max |diff| must be 0), the canvas rBRIEF kernel on that
   frame's 4000 kept keypoints and the per-level rBRIEF kernel on level 0
   and on the smallest level with each level's own keypoints (every word
   equal); each timed with CUDA events beside its twin and beside its
   bound.  The whole GPU frame of either configuration (``use_atlas``
   True and False) is also held against the same frame built on the CPU,
   where the twins run.
3. ``Tracker`` (tracking only) over the 34-frame 1241x376 synthetic
   sequence with 2000 ORB features and 8 levels; the atlas path's kernels
   must have launched at least once per frame, every pose must be finite,
   drift (ATE over track length) under 2.5% and at most 3 weak frames.
4. The fused per-frame program: ``fused_track_chain_step`` over the same
   frames, chained frame to frame, against a landmark mirror frozen after
   the tracker's first frame.
5. The main path: ``System.track_stereo`` over the same 34 frames in the
   default configuration (``use_atlas=True``, loop closing off): every
   pose finite, every frame ``OK``, drift under 2.5%, more than one
   keyframe, local BA ran, the maintenance step created landmarks, the
   fast_score and brief_canvas kernels launched at least once per frame.
   Prints frames/s and the stage times of ``System.times``.
6. The per-level configuration (``use_atlas=False``) through ``System``
   over the first 12 frames: the same requirements, fast_score and
   brief_level launched at least 16 times per frame, brief_canvas not at
   all.

Any failed check raises, so the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
is the card's ``nvidia-smi`` name and power limit, and the one before
that the per-kernel JSON record.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.native import mapcore_ffi
from pyorbslam_tpu_torch.ops import atlas, fast, kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops
from pyorbslam_tpu_torch.ops.hamming import unpack_bits
from pyorbslam_tpu_torch.ops.extractor import DETECT_BORDER
from pyorbslam_tpu_torch.slam.frame import build_stereo_frame
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.slam.tracking import Tracker, fused_track_chain_step
from pyorbslam_tpu_torch.utils.metrics import ate_rmse
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls

N_FRAMES = 34
N_FRAMES_PER_LEVEL = 12   # length of the use_atlas=False System run
WIDTH, HEIGHT = 1241, 376
N_FEATURES = 2000
MAX_DRIFT = 0.025
MAX_WEAK = 3
TIMING_REPS = 25

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 rate and the
# float32 rate outside the tensor cores.  The bounds below are stated
# against these, with the card's power limit printed beside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Arithmetic of the kernels, counted from their plain twins.  FAST per
# pixel: 16 circle differences, 16 negations for the dark polarity, per
# polarity 32 + 32 minimums and a 15-step maximum, one maximum of the two
# and one clamp.  rBRIEF per sample: 4 multiplies, 2 adds, 2 roundings and
# 3 integer ops for the address; per pair one comparison.
FAST_OPS_PER_PIXEL = 16 + 16 + 2 * (32 + 32 + 15) + 2
BRIEF_OPS_PER_KEYPOINT = 512 * 11 + 256


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


def bound_record(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the float32 rate, in ms."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def fast_bound(img: torch.Tensor) -> dict:
    """FAST reads the image once and writes the score once."""
    return bound_record(2 * img.numel() * 4, img.numel() * FAST_OPS_PER_PIXEL)


def brief_bound(n: int) -> dict:
    """rBRIEF is a sparse read: per keypoint the 512 samples it needs
    (not the whole image), its coordinates, cos and sin, and 8 words
    out; the 4 KiB pattern once."""
    return bound_record(n * (512 * 4 + 8 + 8 + 32) + 4096,
                        n * BRIEF_OPS_PER_KEYPOINT)


def record(kernel, err, ms, plain_ms, bound, shape) -> dict:
    # library_ms: no single PyTorch call computes FAST-9 or steered rBRIEF
    return dict(name=kernel.name, route="cuda", source=kernel.source,
                replaces=kernel.replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=None, shape=shape, **bound)


def check_fast(img: torch.Tensor, what: str) -> dict:
    score_k = kernels.fast_score_map(img)
    score_t = fast.fast_score_map(img)
    torch.cuda.synchronize()
    err = float((score_k - score_t).abs().max())
    require(err == 0.0, f"fast_score kernel differs from its twin on {what}: {err}")
    ms = time_ms(lambda: kernels.fast_score_map(img))
    plain_ms = time_ms(lambda: fast.fast_score_map(img))
    bound = fast_bound(img)
    log(f"fast_score  {what} {tuple(img.shape)}: kernel {ms:.4f} ms  twin "
        f"{plain_ms:.4f} ms  bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']})  max|diff| {err}")
    return record(kernels.FAST_SCORE, err, ms, plain_ms, bound,
                  f"{what} {img.shape[0]}x{img.shape[1]}")


def level_keypoints(level_img: torch.Tensor, orb, level: int):
    """One level's keypoints, angles and padded blurred image, as the
    per-level extractor makes them."""
    score = fast.border_mask(kernels.fast_score_map(level_img), DETECT_BORDER)
    score = fast.cell_fallback_mask(score, float(orb.ini_th_fast),
                                    float(orb.min_th_fast), orb.cell_size)
    xy, _, valid = fast.select_keypoints(
        fast.nms3x3(score), int(orb.features_per_level[level]),
        orb.bucket_size, orb.per_bucket_cap)
    m10, m01 = desc_ops.moment_maps(pyr_ops.reflect_pad(level_img, desc_ops.BORDER))
    ang = desc_ops.ic_angle_from_maps(m10, m01, xy)
    padded_blur = pyr_ops.reflect_pad(pyr_ops.gaussian_blur(level_img),
                                      desc_ops.BORDER).contiguous()
    return padded_blur, xy, ang, int(valid.sum())


def check_brief_level(level_img: torch.Tensor, orb, level: int) -> dict:
    padded_blur, xy, ang, n_valid = level_keypoints(level_img, orb, level)
    desc_k = kernels.brief_descriptors_level(padded_blur, xy, ang)
    desc_t = desc_ops.brief_descriptors(padded_blur, xy, ang)
    torch.cuda.synchronize()
    require(torch.equal(desc_k, desc_t),
            f"brief_level kernel differs from its twin on level {level} in "
            f"{int((desc_k != desc_t).sum())} of {desc_k.numel()} words")
    err = float((unpack_bits(desc_k) != unpack_bits(desc_t)).to(torch.float32).max())
    cos, sin = desc_ops.cos_sin(ang)
    cos, sin = cos.contiguous(), sin.contiguous()
    ms = time_ms(lambda: kernels.brief_level_kernel(padded_blur, xy, cos, sin))
    plain_ms = time_ms(lambda: kernels.brief_level_gather(padded_blur, xy, cos, sin))
    bound = brief_bound(xy.shape[0])
    log(f"brief_level level {level} {tuple(padded_blur.shape)}, {xy.shape[0]} "
        f"keypoints ({n_valid} valid): kernel {ms:.4f} ms  twin {plain_ms:.4f} ms  "
        f"bound {bound['bound_ms']:.5f} ms ({bound['bound_by']})  words equal")
    return record(kernels.BRIEF_LEVEL, err, ms, plain_ms, bound,
                  f"level {level}, {xy.shape[0]} keypoints")


def check_kernels(seq, cfg, device) -> list:
    """Phase 2: each kernel against its twin on the frame's own tensors.
    Returns one record per kernel, at the largest shape its path gives it."""
    orb = cfg.orb
    left = torch.as_tensor(seq.left[0], device=device).to(torch.float32)
    right = torch.as_tensor(seq.right[0], device=device).to(torch.float32)
    levels_l = pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels)
    levels_r = pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels)
    kp = atlas.atlas_keypoints(left, right, orb, levels_l, levels_r)
    canvas = kp.canvas
    log(f"canvas {tuple(canvas.shape)}, keypoint slots {kp.cxy.shape[0]}, "
        f"valid {int(kp.valid.sum())}")

    fast_rec = check_fast(canvas, "canvas")
    last = orb.n_levels - 1
    check_fast(levels_l[0].contiguous(), "level 0")
    check_fast(levels_l[last].contiguous(), f"level {last}")

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
    canvas_bound = brief_bound(kp.cxy.shape[0])
    log(f"brief_canvas {kp.cxy.shape[0]} keypoints: kernel {brief_ms:.4f} ms  "
        f"twin {brief_plain_ms:.4f} ms  bound {canvas_bound['bound_ms']:.5f} ms "
        f"({canvas_bound['bound_by']})  words {desc_k.shape[0]}x{desc_k.shape[1]} equal")
    canvas_rec = record(kernels.BRIEF_CANVAS, brief_err, brief_ms, brief_plain_ms,
                        canvas_bound, f"canvas, {kp.cxy.shape[0]} keypoints")

    level_rec = check_brief_level(levels_l[0].contiguous(), orb, 0)
    check_brief_level(levels_l[last].contiguous(), orb, last)
    return [fast_rec, canvas_rec, level_rec]


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
    log(f"frame (use_atlas={cfg.orb.use_atlas}) GPU vs CPU: keypoints equal, "
        f"descriptor bits agree "
        f"{agree:.6f}, stereo-matched flags agree {same_matched:.6f}, "
        f"valid {int(gpu['valid'].sum())}, matched {int(matched_g.sum())}")
    require(agree >= 0.999, f"descriptor bit agreement {agree}")
    require(same_matched >= 0.99, f"stereo-matched agreement {same_matched}")


ATLAS_KERNELS = ("fast_score", "brief_canvas")
STAGES = ("perframe.track", "kf.insert_total", "kf.maintain", "kf.local_ba")
BA_STAGES = ("ba.assemble", "ba.solve")


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
    for name in ATLAS_KERNELS:
        require(counts[name] >= N_FRAMES,
                f"{name} launched {counts[name]} times over {N_FRAMES} frames")
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
    for name in ATLAS_KERNELS:
        require(counts[name] >= N_FRAMES - 1,
                f"{name} launched {counts[name]} times over {N_FRAMES - 1} "
                f"fused frames")
    require(drift < MAX_DRIFT, f"fused drift {drift:.4f} >= {MAX_DRIFT}")
    return dict(counts=counts, fps=fps)


def run_system(seq, cfg, device, n_frames: int, min_launches: dict,
               unused: tuple) -> dict:
    """Phases 5 and 6: ``System.track_stereo`` over the first ``n_frames``
    frames with loop closing off.  ``min_launches`` maps a kernel's name
    to its least launches per frame; kernels in ``unused`` must not have
    launched."""
    which = f"System(use_atlas={cfg.orb.use_atlas})"
    system = System(cfg, device, keyframe_capacity=256,
                    enable_loop_closing=False)
    kernels.reset_launch_counts()
    states = []
    t_first = None
    t0 = time.perf_counter()
    for i in range(n_frames):
        system.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        states.append(system.state)
        if t_first is None:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
    system.shutdown()
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()

    poses = system.corrected_trajectory()
    require(len(poses) == n_frames, f"{which}: a frame was not tracked")
    require(bool(np.isfinite(poses).all()), f"{which}: non-finite pose")
    ate, drift, length = drift_of(list(poses), seq, n_frames)
    ba_runs = [e[2] for e in system.events
               if isinstance(e, tuple) and e[0] == "local_ba"]
    maintains = [e[2] for e in system.events
                 if isinstance(e, tuple) and e[0] == "maintain"]
    n_ba = sum(1 for r in ba_runs if r.get("ran"))
    n_new = sum(r["new"] for r in maintains)
    n_fused = sum(r["fused"] for r in maintains)
    n_kfs = system.map.keyframes.n
    fps = (n_frames - 1) / (elapsed - t_first)
    log(f"{which}: {n_frames} frames, first {t_first:.3f} s, then {fps:.3f} "
        f"frames/s; ATE {ate:.4f} m over {length:.2f} m (drift "
        f"{100 * drift:.3f}%), keyframes {n_kfs}, landmarks alive "
        f"{int(system.map.landmarks.alive.sum())} of {system.map.landmarks.n}, "
        f"local BA ran {n_ba} of {len(ba_runs)}, triangulated {n_new}, fused "
        f"{n_fused}, fallbacks to separate steps "
        f"{sum(1 for r in maintains if r['fallback'])}, launches {counts}")
    for label, times, n_of in (
            [(k, system.times, system.time_counts) for k in STAGES]
            + [(k, system.map.times, None) for k in BA_STAGES]):
        n = n_of[label] if n_of is not None else n_ba
        if n:
            log(f"  {label}: {1e3 * times[label] / n:.2f} ms each over {n} calls")
    log(f"  BA counters: {dict(system.map.counters)}; local BA sizes: "
        f"{[(r['n_cams'], r['n_points'], r['n_obs']) for r in ba_runs if r.get('ran')]}")
    require(all(s == "OK" for s in states),
            f"{which}: frame states {sorted(set(states))}")
    require("sync:weak" not in system.events, f"{which}: weak tracking")
    require(drift < MAX_DRIFT, f"{which}: drift {drift:.4f} >= {MAX_DRIFT}")
    require(n_kfs > 1, f"{which}: {n_kfs} keyframes")
    require(n_ba >= 1, f"{which}: local BA never ran")
    require(n_new > 0, f"{which}: the maintenance step created no landmark")
    for name, per_frame in min_launches.items():
        require(counts[name] >= per_frame * n_frames,
                f"{which}: {name} launched {counts[name]} times over "
                f"{n_frames} frames, expected {per_frame} per frame")
    for name in unused:
        require(counts[name] == 0, f"{which}: {name} launched {counts[name]} times")
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
    mapcore_ffi.build()
    log(f"map core built in {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    seq, cfg = make_sequence()
    cfg_levels = dataclasses.replace(
        cfg, orb=dataclasses.replace(cfg.orb, use_atlas=False))
    log(f"rendered {N_FRAMES} frames of {WIDTH}x{HEIGHT} in "
        f"{time.perf_counter() - t0:.1f} s")

    records = check_kernels(seq, cfg, device)
    check_frame_against_cpu(seq, cfg, device)
    check_frame_against_cpu(seq, cfg_levels, device)
    tracked = run_tracker(seq, cfg, device)
    fused = run_fused_chain(seq, cfg, device, tracked["snapshot"])
    main_path = run_system(seq, cfg, device, N_FRAMES,
                           {"fast_score": 1, "brief_canvas": 1},
                           unused=("brief_level",))
    per_level = run_system(seq, cfg_levels, device, N_FRAMES_PER_LEVEL,
                           {"fast_score": 16, "brief_level": 16},
                           unused=("brief_canvas",))
    log(f"frames/s on the card: Tracker {tracked['fps']:.3f}, "
        f"fused_track_chain_step {fused['fps']:.3f}, System "
        f"{main_path['fps']:.3f}, System per level {per_level['fps']:.3f}")

    # launches: each kernel's count from the System run of its own path
    launches = dict(main_path["counts"])
    launches["brief_level"] = per_level["counts"]["brief_level"]
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        require(rec["launches"] > 0, f"{rec['name']} never launched on its path")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
