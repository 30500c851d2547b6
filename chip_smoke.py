#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--kernels-only]

1. Device and build: refuses to run without CUDA, turns TF32 off, prints
   the card's name and power limit, builds the four CUDA kernels from
   ``pyorbslam_tpu_torch/csrc`` (one nvcc each, started together) and
   the native map core, and prints the build time and each kernel's
   registers, shared memory and spills.
2. Kernels against their plain twins at the paths' own shapes.  The FAST
   kernel on the 4224x1279 atlas canvas of a 1241x376 stereo frame, on
   each of the frame's 16 level images singly and through the one
   multi-image launch, and on awkward shapes (an image smaller than a
   halo, one column, one row, sizes just off a vector and a tile): max
   |diff| must be 0.  The canvas rBRIEF kernel on that frame's 4000 kept
   keypoints at 1, 2, 4 and 8 warps a block, with corner keypoints and an
   empty list, beside an empty kernel on the same grid (its launch
   floor) and again on the 8000 keypoints of a 4000-feature frame; the
   per-level rBRIEF kernel on level 0, on the smallest
   level, on the frame's 16 images in one launch with each level's own
   keypoints, and with corner keypoints and an image without keypoints in
   the list: every word equal.  Each kernel is timed three ways beside its
   twin and its bound: one launch between two CUDA events (``ms``), a
   stream of launches (``stream_ms``, the host's enqueue rate where that is
   the slower) and launches replayed from a CUDA graph (``graph_ms``, the
   card's own time).  Every one of these clocks times the kernel's launch
   function (``kernels.*_kernel``: argument checks, output allocation,
   image table, launch) on prepared inputs, and the twin's ``plain_ms`` is
   taken on the same inputs.  fast_score's and brief_canvas' records are
   taken on the canvas, brief_level's on the frame's 16 images in one
   launch: the shapes their paths launch.  For fast_score and brief_level
   the frame's one launch also stands under ``frame_ms``,
   ``frame_graph_ms``, ``frame_plain_ms`` and ``frame_bound_ms``, beside
   one launch an image (``frame_singles_ms``, ``frame_singles_graph_ms``)
   and the public wrapper in a stream (``frame_wrapper_ms``; for
   brief_level it adds cos and sin, three concatenations and the bounds
   check's host read).
   The pose optimizer's kernel (K4, ``csrc/pose_opt.cu``) against its twin
   ``pose_optimization_ref`` on the same card tensors, at the path's shapes:
   the 2048 slots of a 2000-feature frame and the slots of bench.py's
   8000-feature frame, ~40% of the edges active and 20% outliers (poses
   within 1e-4, inlier masks equal but on edges within 1% of the gate),
   with the same three clocks beside the twin's and its bound.
   With ``--kernels-only`` the script renders a 2-frame sequence of the
   same size and stops here.  The whole GPU frame of either configuration
   (``use_atlas`` True and False) is also held against the same frame
   built on the CPU, where the twins run.
3. ``Tracker`` (tracking only) over the 34-frame 1241x376 synthetic
   sequence with 2000 ORB features and 8 levels; the atlas path's kernels
   must have launched at least once per frame, every pose must be finite,
   drift (ATE over track length) under 2.5% and at most 3 weak frames.
4. The fused per-frame program: ``fused_track_chain_step`` over the same
   frames, chained frame to frame, against a landmark mirror frozen after
   the tracker's first frame.
5. The main path: ``System.track_stereo`` over the same 34 frames in the
   default configuration (``use_atlas=True``, loop closing on): every
   pose finite, every frame ``OK``, drift under 2.5%, 12 keyframes, local
   BA ran, the maintenance step triangulated 2713 landmarks, the
   fast_score and brief_canvas kernels launched exactly once per frame,
   brief_level not at all; the loop stage ran on every keyframe and
   closed nothing (the straight sequence never revisits a place).  Prints
   frames/s and the stage times of ``System.times`` (``kf.loop`` and
   ``kf.gba_slice`` among them) and the loop closer's ``detect`` calls.
   In this and every other ``run_system`` run the span recorder is on, and
   pose_opt must have launched once per ``track.pose_opt`` span: the
   kernel, never the twin, ran every pose optimization.
6. The per-level configuration (``use_atlas=False``) through ``System``
   over the first 12 frames: the same requirements (5 keyframes, 859
   triangulated), fast_score and brief_level launched exactly once per
   frame, brief_canvas not at all.

7. The pipelined schedule, the main path: ``System.track_stereo_async``
   over the same 34 frames, ``flush_async``, ``shutdown``: 34 committed
   poses, every frame ``OK``, no ``async:rescue`` event, more than one
   keyframe, local BA ran, drift under 2.5% and ATE under max(2 x the
   synchronous run's, 0.15 m), fast_score and brief_canvas launched
   exactly once per frame, nothing left in flight, and no synchronizing
   CUDA call inside a dispatch (PyTorch's sync debug mode: no read-back,
   no upload from pageable memory): neither in the frame's dispatch
   (``_dispatch_chain``) nor in the keyframe stages the non-blocking
   maintenance queue dispatches (``LocalMapper.maintain_dispatch``,
   ``SlamMap.local_ba(split=True)``).  The loop stage reads its own
   results by design and is not watched.  Prints the ``async.*`` and
   ``kf.*_dispatch`` / ``kf.*_apply`` timers and frames/s.  Then a kidnap:
   two frames of seeded noise, then frame 5 again; the commit must
   rescue, tracking must break, and relocalization (BoW candidates, EPnP)
   must bring the state back to ``OK`` within 0.5 m.  Then the per-level
   configuration pipelined over 12 frames under the same watch: 0
   synchronizing calls, fast_score and brief_level once a frame.
8. A loop at full width, pipelined: 1241x376, 2000 features,
   ``generate_sequence(trajectory="loop", laps=1.15, seed=11)`` over 96
   frames (the scene width is the generator's own for a loop, 2 x radius
   + 12 m) through ``track_stereo_async``, ``flush_async``, ``shutdown``:
   a pose and a state for every frame, finite poses, fast_score and
   brief_canvas once a frame, the loop stage on every keyframe, nothing in
   flight.  Logs every ``loop.*`` stage time, the Sim3
   ladder's events, loops closed / rejected / fused and the ATE of the raw
   and of the corrected trajectory.  No closure is required here (see
   ``PERF.md``).
9. The tier-1 loop sequence of ``tests/conftest.py::full_loop_run`` (512x160,
   92 frames, 1000 features) through ``track_stereo``: at least one loop
   closed, loop edges recorded, corrected ATE under 0.6 m
   (``tests/test_loop_closing.py``'s gates); then a Sim3 6 m and 20 deg
   off handed to ``correct`` must be rolled back; then global BA by the
   ``cg`` engine against the dense engine on all live keyframes from the
   same state (camera centres within 2 cm).

10. The windowed schedule, ``W = 4``.  (a) ``System.track_stereo_window``
    over phase 5's 34 frames (frame 0 initializes, frames 1-3 are scanned,
    the last window holds 2 frames); (b) ``System.window_feed`` /
    ``window_flush`` on a 34-frame 1241x376 straight sequence at 0.5 m a
    frame (seed 3, the schedule's operating envelope), beside a
    ``track_stereo`` run on it (phase 5's requirements).  Both: every pose
    returned once and finite, at least 3 keyframes, nothing in flight
    after ``shutdown``, fast_score and brief_canvas launched once per
    scanned frame plus once per frame that ``track_stereo`` took (the
    bootstrap, an aborted window's tail), and no synchronizing CUDA call
    inside ``_dispatch_window``; every committed rotation orthonormal
    (|R R^T - I| under 1e-5) and the ATE under the JAX package's gate
    (3 x phase 5's or 0.05 m; 7 x the per-frame run's or 0.25 m;
    tests/test_system.py::TestWindowedTracking).  Prints the ``window.*`` timers, frames/s and the ``retrack:*`` /
    ``abort:*`` counts.
11. Checkpoint: phase 5's map through ``utils/checkpoint.py``
    (``save_map``, ``load_map`` on the card): keyframe and landmark counts,
    poses, positions and observations equal, the covisibility the recount
    of the observations; then the loaded map swapped into phase 5's
    ``System``, which tracks its last frame four more times (the camera
    stops): state ``OK`` or ``MARGINAL``, more than 30 inliers.
12. The sharded engines (``parallel/``) on the one card.  Phase 5's map
    tiled as tests/test_dist_gba_scale.py tiles its own (rigid copies on a
    ring, >= 512 cameras and >= 200k observations, poses noised by 3 cm)
    through ``distributed_bundle_adjust_cg`` on 4 shards of ``cuda:0`` and
    on an NCCL group of world size 1 (``multihost.initialize``), each
    against ``bundle_adjust_cg`` on the same problem: median centre error
    within 1.5x the single device's + 1 mm and under 0.8x the start's, and
    every camera translation within 2e-3 m of the single device's
    (tests/test_dist_ba.py's tolerance; a lost shard's sum would leave its
    copies' cameras near the start).
    Global BA's ``dist`` rung on phase 9's map (``make_mesh()``, and 4
    shards) beside the ``cg`` and dense rungs from one state: camera
    centres within 2 cm.  ``distributed_pose_graph`` on 4 shards against
    ``optimize_pose_graph_cg``: R and t within 5e-3.  Every engine's time
    is printed with the card's name and power limit; nothing is claimed
    for scaling, every shard being on the one card.
13. The viewer: ``LiveViewer`` on port 0 while a pipelined ``System``
    tracks phase 5's first 12 frames, ``/state`` fetched after every frame:
    tests/test_viewer.py's fields, no synchronizing CUDA call inside a
    dispatch (phase 7's watch) nor in the viewer's thread while it serves,
    fast_score and brief_canvas once a frame.
14. The renderer: ``TorchRenderer`` on the card against the numpy renderer
    on 3 frames of ``SyntheticStream``'s loop world (60 m radius, seed 11)
    at 1241x376, tests/test_render_jax.py's gates (median |diff| <= 1,
    under 2% of pixels off by more than 2); ms a frame beside the host's
    numpy time.

15. The at-scale loop, the main path over hundreds of keyframes:
    ``SyntheticStream(n_frames=420, 1241x376, trajectory="loop",
    scene="interior", loop_radius=33, laps=2.3, render_backend="torch")``
    (the JAX package's ``EVAL_SCALE_R5_23`` world, 700 frames at radius 55,
    cut to 420 frames at radius 33: the same 2.3 laps and ~1.13 m a frame;
    320 frames at radius 25 give fewer keyframes than global BA's cg rung
    needs),
    2000 features, the default ``System(cfg, device)``; every frame rendered
    on the card before the run, then ``track_stereo_async`` on every frame,
    ``flush_async``, ``shutdown``.  Every pose finite, the final state
    ``OK``, nothing in flight, fast_score and brief_canvas once a frame,
    at least 97 live keyframes, the loop machinery engaged (closed plus
    rejected at least 1), the corrected trajectory's ATE under 1% of the
    path, 0 synchronizing calls in the 10 dispatches from frame 250 and in
    the keyframe stages queued in them (phase 7's watch); then one
    ``SlamMap.global_ba()`` on the final map over more than 96 cameras (the
    ``cg`` rung), which must run, not be rejected and not raise the chi2
    of the observations it optimizes (the stereo ones: bundle adjustment
    takes no monocular observation); the map's whole reprojection chi2,
    monocular observations included, is printed beside it.  Prints frames/s over the first and the last 100
    frames, keyframes, landmarks, loops, the loop stage's totals, peak
    device memory after frames 100, 200, 320 and 420, and the host's RSS.

16. The bench, ``pyorbslam_tpu_torch/bench.py``, through ``run_config``
    (the function its command line calls), every ``BENCH_CONFIG``: the
    default (the pipelined schedule with the tracking program's
    ``tracking_only_fps``) at bench.py's own 66 frames (34 for the
    tracking program) and three timed passes, its ATE under phase 7's gate
    (max(2 x phase 5's synchronous ATE, 0.15 m)) and no ``async:rescue``;
    then the default in ``BENCH_MODE=stream`` and every other
    configuration (per-frame, 8000-feature high density, windows of W = 8
    in both windowed schedules, the tracking program at 2000 and 8000
    features in both modes) at 16 frames and one timed pass.  Every run:
    the bench's own check that every frame got a pose, finite poses,
    nothing in flight, fast_score and brief_canvas launched exactly once
    per frame built (``build_stereo_frame`` calls counted).  Prints every
    bench line (one JSON object) and each run's seconds, frames built,
    launches and peak device memory.  Then brief_canvas at the
    high-density slot count (an 8000-feature frame) against its twin,
    every word, at 1, 2, 4 and 8 warps a block, each with its three
    clocks; the shipped block size is not changed.

The two loop sequences, phase 10b's sequence, phase 14's numpy renders,
phase 15's world (its 4096-px texture) and phase 16's 66- and 16-frame
sequences (into the bench's cache) are made in worker processes while
phases 2-7 run on the card.

Any failed check raises, so the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before it
is the card's ``nvidia-smi`` name and power limit, and the one before
that the per-kernel JSON record.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import datetime
import multiprocessing
import json
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from collections import Counter
import warnings

import numpy as np
import torch

from pyorbslam_tpu_torch import bench, convert
from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io import synthetic
from pyorbslam_tpu_torch.io.render_torch import TorchRenderer
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.native import mapcore_ffi
from pyorbslam_tpu_torch.ops import atlas, fast, kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops
from pyorbslam_tpu_torch.ops.hamming import unpack_bits
from pyorbslam_tpu_torch.ops.extractor import level_keypoints
from pyorbslam_tpu_torch.optim import ba, ba_cg, pose_opt
from pyorbslam_tpu_torch.optim.pose_graph import optimize_pose_graph_cg
from pyorbslam_tpu_torch.parallel import dist_ba, multihost
from pyorbslam_tpu_torch.slam import system as system_mod
from pyorbslam_tpu_torch.slam import tracking as tracking_mod
from pyorbslam_tpu_torch.slam.frame import build_stereo_frame
from pyorbslam_tpu_torch.slam.slam_map import GBA_DENSE_MAX_KFS
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.slam.tracking import Tracker, fused_track_chain_step
from pyorbslam_tpu_torch.tools import eval_scale, gba_tiling
from pyorbslam_tpu_torch.tools import multihost_dryrun as dryrun
from pyorbslam_tpu_torch.tools.timing import time_graph_ms, time_ms, time_stream_ms
from pyorbslam_tpu_torch.utils import checkpoint, trace
from pyorbslam_tpu_torch.utils.metrics import ate_rmse
from pyorbslam_tpu_torch.utils.precision import use_f32_matmuls
from pyorbslam_tpu_torch.viz.live_viewer import LiveViewer

N_FRAMES = 34
N_FRAMES_PER_LEVEL = 12   # length of the use_atlas=False System runs
# the loop sequences: tests/conftest.py::full_loop_run's (laps > 1: the
# revisit dwells past the start), at full width and at its own 512x160
LOOP_SEQ = dict(trajectory="loop", laps=1.15, seed=11)
N_LOOP_FRAMES = 96
TIER1_LOOP = dict(n_frames=92, width=512, height=160, n_features=1000)
# phase 10: windows of W frames; 10b's sequence is slower (the envelope of
# window_feed: about 2 m a window at KITTI-like depths)
WINDOW = 4
FEED_SEQ = dict(trajectory="straight", speed=0.5, seed=3)
# phase 12: shards of the sharded engines on the one card, and
# tests/test_dist_gba_scale.py's tiling
SHARDS = 4
GBA_TILE = dict(min_cams=512, min_obs=200_000)
GBA_ITERS = dict(iters1=3, iters2=0, cg_iters=48)
SHARD_T_TOL = 2e-3        # tests/test_dist_ba.py: sharded against one device, m
# phase 13: frames tracked while the viewer is polled; phase 14: the loop
# scene's frames the renderer draws
N_VIEWER_FRAMES = 12
RENDER_FRAMES = (0, 32, 64)
# phase 15: the JAX package's EVAL_SCALE_R5_23 world (700 frames, radius
# 55, 2.3 laps) cut to 420 frames at radius 33, which keeps its laps and
# its ~1.13 m a frame; the sync watch's first frame and length; the
# frames after which peak device memory is read
SCALE_SEQ = dict(n_frames=420, trajectory="loop", scene="interior",
                 loop_radius=33.0, laps=2.3)
SCALE_WATCH = (250, 10)
SCALE_MEM_AT = (100, 200, 320)
SCALE_MIN_KFS = GBA_DENSE_MAX_KFS + 1   # global BA then takes its cg rung
SCALE_MAX_DRIFT = 0.01      # the odometry class: EVAL_SCALE_R5.json's loop-off run, 0.86%
# phase 16: (BENCH_CONFIG, BENCH_MODE) of the bench's runs, the first at
# bench.py's own lengths and passes, the others at BENCH_SHORT_FRAMES and
# one timed pass
BENCH_RUNS = (("", "scan"), ("", "stream"), ("perframe", "scan"),
              ("pipeline", "scan"), ("highdensity_pipeline", "scan"),
              ("pipeline_window", "scan"), ("pipeline_pipelined", "scan"),
              ("tracking", "scan"), ("tracking", "stream"),
              ("highdensity", "scan"), ("highdensity", "stream"))
BENCH_SHORT_FRAMES = 16
WIDTH, HEIGHT = 1241, 376
N_FEATURES = 2000
MAX_DRIFT = 0.025
MAX_WEAK = 3

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 rate and the
# float32 rate outside the tensor cores.  The bounds below are stated
# against these, with the card's power limit printed beside them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# Arithmetic of the kernels in the least form that gives the twins' values.
# FAST per pixel: rounding is monotone, so the arc searches run on the raw
# circle pixels (per polarity 32 + 32 two-input minimums and a 15-step
# maximum, 79 operations) and the centre is subtracted once per polarity; one
# negation for the dark polarity, one maximum of the two and one clamp.  (With
# three-input min/max the count halves and the bytes govern the bound.)
# rBRIEF per sample: 4 multiplies, 2 adds, 2 roundings and 3 integer ops for
# the address; per pair one comparison.
FAST_OPS_PER_PIXEL = 2 * (32 + 32 + 15) + 2 + 1 + 2
BRIEF_OPS_PER_KEYPOINT = 512 * 11 + 256
# pose_opt per edge: the residual (the point 18, the clamp and 1/z 3, u, v,
# ur, e 11) 32 and chi2 6 in every pass; pass 1 adds the Huber weight 5, the
# Jacobian's factors and 12 nonzero entries 24, 21 H entries and 6 b entries
# at 7 each and the cost 6; pass 2 the cost 6; a gate its compare 2.
# Bytes: Xw, obs, inv_sigma2 and active0 read once (29 an edge), chi2 and
# the mask written once (5).
POSE_OPS_PASS1 = 32 + 6 + 5 + 24 + 27 * 7 + 6
POSE_OPS_PASS2 = 32 + 6 + 6
POSE_OPS_GATE = 32 + 6 + 2
POSE_BYTES_PER_EDGE = 29 + 5


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


def config_of(seq, n_features: int) -> SlamConfig:
    height, width = seq.left.shape[1:]
    return SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=width, height=height, bf=seq.bf, th_depth=40.0,
        ),
        orb=OrbConfig(n_features=n_features),
    )


def straight_sequence(n_frames: int):
    """bench.py's straight sequence, kept in the bench's cache: phase 16
    reads its 34-, 66- and 16-frame versions there."""
    return generate_sequence(n_frames=n_frames, width=WIDTH, height=HEIGHT,
                             trajectory="straight", speed=0.8, seed=3,
                             cache_dir=bench.CACHE_DIR)


def make_sequence(n_frames: int = N_FRAMES):
    seq = straight_sequence(n_frames)
    return seq, config_of(seq, N_FEATURES)


def render_bench_sequence(n_frames: int) -> None:
    """A pool job: the sequence into the cache, nothing sent back."""
    straight_sequence(n_frames)


def loop_scene_reference() -> dict:
    """Phase 14's reference: ``SyntheticStream``'s full-width loop world
    (60 m radius, seed 11) and its numpy renders of ``RENDER_FRAMES``
    (left camera), each timed on the host."""
    stream = synthetic.SyntheticStream(n_frames=N_LOOP_FRAMES, width=WIDTH,
                                       height=HEIGHT, **LOOP_SEQ)
    frames, host_s = [], []
    for i in RENDER_FRAMES:
        t0 = time.perf_counter()
        frames.append(synthetic._to_u8(synthetic.render_view(
            stream.poses_wc[i], stream.K, WIDTH, HEIGHT, stream._planes,
            stream._tex)))
        host_s.append(time.perf_counter() - t0)
    return dict(planes=stream._planes, tex=stream._tex, K=stream.K,
                poses=stream.poses_wc[list(RENDER_FRAMES)], frames=frames,
                host_s=host_s)


def start_renders(pool):
    """Render the two loop sequences, phase 10b's sequence and phase 14's
    reference, build phase 15's world and render phase 16's sequences into
    the bench's cache, in worker processes while the card runs phases 2-7:
    (full-width loop, tier-1 loop, window_feed sequence, loop scene
    reference, scale stream, bench sequences) futures."""
    full = pool.submit(generate_sequence, n_frames=N_LOOP_FRAMES, width=WIDTH,
                       height=HEIGHT, **LOOP_SEQ)
    small = pool.submit(generate_sequence, n_frames=TIER1_LOOP["n_frames"],
                        width=TIER1_LOOP["width"], height=TIER1_LOOP["height"],
                        **LOOP_SEQ)
    feed = pool.submit(generate_sequence, n_frames=N_FRAMES, width=WIDTH,
                       height=HEIGHT, **FEED_SEQ)
    scale = pool.submit(synthetic.SyntheticStream, width=WIDTH, height=HEIGHT,
                        render_backend="torch", **SCALE_SEQ)
    bench_seqs = [pool.submit(render_bench_sequence, n)
                  for n in (bench.PIPELINE_FRAMES, BENCH_SHORT_FRAMES)]
    return full, small, feed, pool.submit(loop_scene_reference), scale, bench_seqs


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


def brief_bound(*parts) -> dict:
    """rBRIEF is a sparse read: per keypoint the 512 samples it needs, but
    of each image no more than the whole image, which every sample lies
    in; per keypoint its coordinates, cos and sin, and 8 words out; the
    4 KiB pattern once.  ``parts``: (keypoints, f32 elements of the image
    they sample) for each image of the launch."""
    n = sum(k for k, _ in parts)
    samples = sum(min(k * 512 * 4, pixels * 4) for k, pixels in parts)
    return bound_record(samples + n * (8 + 8 + 32) + 4096,
                        n * BRIEF_OPS_PER_KEYPOINT)


def clocks(fn) -> dict:
    """The three clocks of one kernel call: one bracketed launch, a stream
    of launches, launches replayed from a CUDA graph."""
    return dict(ms=time_ms(fn), stream_ms=time_stream_ms(fn),
                graph_ms=time_graph_ms(fn))


def record(kernel, err, times, plain_ms, bound, shape) -> dict:
    # library_ms: no single PyTorch call computes FAST-9 or steered rBRIEF
    return dict(name=kernel.name, route="cuda", source=kernel.source,
                replaces=kernel.replaces, max_abs_err=err, **times,
                plain_ms=plain_ms, library_ms=None, shape=shape, **bound)


def show(what: str, rec: dict, tail: str) -> None:
    log(f"{what}: kernel {rec['ms']:.4f} ms  in a stream {rec['stream_ms']:.5f} ms"
        f"  in a graph {rec['graph_ms']:.5f} ms  twin {rec['plain_ms']:.4f} ms  "
        f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})  {tail}")


def fast_err(img: torch.Tensor, score_k: torch.Tensor, what: str) -> float:
    err = float((score_k - fast.fast_score_map(img)).abs().max())
    require(err == 0.0, f"fast_score kernel differs from its twin on {what}: {err}")
    return err


def check_fast(img: torch.Tensor, what: str) -> dict:
    err = fast_err(img, kernels.fast_score_map(img), what)
    rec = record(kernels.FAST_SCORE, err,
                 clocks(lambda: kernels.fast_score_maps_kernel([img])),
                 time_ms(lambda: fast.fast_score_map(img)), fast_bound(img),
                 f"{what} {img.shape[0]}x{img.shape[1]}")
    show(f"fast_score  {what} {tuple(img.shape)}", rec, f"max|diff| {err}")
    return rec


def check_fast_awkward(device) -> None:
    """Shapes around the kernel's tile and halo: an image smaller than a
    halo, one column, one row, widths just past a vector and a tile,
    heights off the tile, and all of them in one launch."""
    rng = np.random.default_rng(4)
    shapes = [(5, 7), (40, 1), (1, 50), (37, 33), (19, 130), (70, 65), (3, 4)]
    imgs = [torch.as_tensor(rng.uniform(0, 255, s).astype(np.float32), device=device)
            for s in shapes]
    for img in imgs:
        fast_err(img, kernels.fast_score_map(img), f"a {tuple(img.shape)} image")
    for img, score in zip(imgs, kernels.fast_score_maps(imgs)):
        fast_err(img, score, f"a {tuple(img.shape)} image among {len(imgs)}")
    log(f"fast_score  awkward shapes {shapes}: max|diff| 0.0 singly and in one launch")


def brief_words_err(desc_k, desc_t, what: str) -> float:
    require(desc_k.shape == desc_t.shape and torch.equal(desc_k, desc_t),
            f"{what} kernel differs from its twin in "
            f"{int((desc_k != desc_t).sum())} of {desc_k.numel()} words")
    return float((unpack_bits(desc_k) != unpack_bits(desc_t)).to(torch.float32).max())


def check_brief_canvas(kp, what: str) -> dict:
    """brief_canvas on one frame's kept keypoints: every word against the
    twin at each block size the launch takes, the three clocks at the
    shipped block size and at 1, 2, 4 and 8 warps a block, and the launch
    floor (an empty kernel on the same grid) beside them."""
    n = kp.cxy.shape[0]
    dev = kp.blur.device
    cos, sin = (t.contiguous() for t in desc_ops.cos_sin(kp.angle))
    twin = kernels.brief_descriptors_canvas_ref(kp.blur, kp.cxy, kp.angle)
    err = brief_words_err(
        kernels.brief_descriptors_canvas(kp.blur, kp.cxy, kp.angle), twin,
        f"brief_canvas ({what})")
    by_warps = {}
    for warps in (1, 2, 4, 8):
        def launch(warps=warps):
            return kernels.brief_canvas_kernel(kp.blur, kp.cxy, cos, sin, warps)
        brief_words_err(launch(), twin, f"brief_canvas ({what}, {warps} warps a block)")
        by_warps[str(warps)] = clocks(launch)
    rec = record(
        kernels.BRIEF_CANVAS, err,
        clocks(lambda: kernels.brief_canvas_kernel(kp.blur, kp.cxy, cos, sin)),
        time_ms(lambda: kernels.brief_canvas_gather(kp.blur, kp.cxy, cos, sin)),
        brief_bound((n, kp.blur.numel())), f"canvas, {n} keypoints")
    rec["floor_graph_ms"] = time_graph_ms(
        lambda: kernels.brief_canvas_floor_kernel(dev, n))
    rec["clocks_by_warps"] = by_warps
    show(f"brief_canvas {what}", rec, "words equal")
    log(f"brief_canvas {what}: launch floor (empty kernel, same grid) "
        f"{rec['floor_graph_ms']:.5f} ms in a graph, so the body takes "
        f"{rec['graph_ms'] - rec['floor_graph_ms']:.5f} ms; half the bound is "
        f"reached at {2 * rec['bound_ms']:.5f} ms; clocks by warps a block "
        f"{by_warps} (shipped: {kernels.BRIEF_CANVAS_WARPS})")
    return rec


def check_brief_canvas_edges(kp, device) -> None:
    """Keypoints as close to the canvas' four corners as the pattern's
    reach allows, and an empty keypoint list."""
    hc, wc = kp.blur.shape
    r = kernels.BRIEF_REACH
    xy = torch.tensor([[r, r], [wc - r - 1, r], [r, hc - r - 1],
                       [wc - r - 1, hc - r - 1]], dtype=torch.int32, device=device)
    ang = torch.tensor([45.0, 135.0, 225.0, 315.0], device=device)
    brief_words_err(kernels.brief_descriptors_canvas(kp.blur, xy, ang),
                    kernels.brief_descriptors_canvas_ref(kp.blur, xy, ang),
                    "brief_canvas (corner keypoints)")
    none = kernels.brief_descriptors_canvas(kp.blur, xy[:0], ang[:0])
    require(tuple(none.shape) == (0, 8) and none.dtype == torch.int32,
            f"brief_canvas on no keypoints gave {tuple(none.shape)} {none.dtype}")
    log("brief_canvas corner keypoints at the pattern's reach and an empty "
        "keypoint list: words equal")


def log_brief_canvas_sass() -> None:
    """Count the global loads that brief_canvas starts before its first
    vote (ballot), from the SASS of the built library: 8 pattern reads, the
    keypoint's three and the lane's 16 samples should all precede it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        log("brief_canvas SASS: cuobjdump not found, order of loads not read")
        return
    dump = subprocess.run(
        [tool, "-sass", kernels.BRIEF_CANVAS.library_path],
        capture_output=True, text=True, timeout=120).stdout
    sass = next((sec for sec in dump.split("Function :")
                 if "brief_canvas_kernel" in sec.split("\n", 1)[0]), "")
    ops = [ln.split("*/")[1].split()[0:2] for ln in sass.splitlines()
           if ln.strip().startswith("/*") and "*/" in ln and ";" in ln]
    names = [o[1] if o and o[0].startswith("@") and len(o) > 1 else (o[0] if o else "")
             for o in ops]
    votes = [i for i, nm in enumerate(names) if nm.startswith("VOTE")]
    loads = [i for i, nm in enumerate(names) if nm.startswith("LDG")]
    if not votes:
        log(f"brief_canvas SASS: no VOTE among {len(names)} instructions read")
        return
    log(f"brief_canvas SASS: {sum(1 for i in loads if i < votes[0])} of "
        f"{len(loads)} global loads come before the first of "
        f"{len(votes)} votes ({len(names)} instructions)")


def check_brief_level(padded_blur, xy, ang, level: int) -> None:
    err = brief_words_err(kernels.brief_descriptors_level(padded_blur, xy, ang),
                          desc_ops.brief_descriptors(padded_blur, xy, ang),
                          f"brief_level (level {level})")
    cos, sin = (t.contiguous() for t in desc_ops.cos_sin(ang))
    rec = record(
        kernels.BRIEF_LEVEL, err,
        clocks(lambda: kernels.brief_level_kernel(padded_blur, xy, cos, sin)),
        time_ms(lambda: kernels.brief_level_gather(padded_blur, xy, cos, sin)),
        brief_bound((xy.shape[0], padded_blur.numel())),
        f"level {level}, {xy.shape[0]} keypoints")
    show(f"brief_level level {level} {tuple(padded_blur.shape)}, {xy.shape[0]} "
         f"keypoints", rec, "words equal")


def check_brief_corners(padded, xys, angs, device) -> None:
    """One launch over the frame's images with an image without keypoints
    in the middle of the list and, on the first and the last image,
    keypoints at the level's four corners."""
    def corners(img):
        h, w = img.shape[0] - 2 * desc_ops.BORDER, img.shape[1] - 2 * desc_ops.BORDER
        return torch.tensor([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                            dtype=torch.int32, device=device)

    xys, angs = list(xys), list(angs)
    mid = len(padded) // 2
    xys[mid], angs[mid] = xys[mid][:0], angs[mid][:0]
    for i in (0, len(padded) - 1):
        xys[i] = torch.cat([corners(padded[i]), xys[i]])
        angs[i] = torch.cat([angs[i][:4] + 45.0, angs[i]])
    brief_words_err(kernels.brief_descriptors_levels(padded, xys, angs),
                    kernels.brief_descriptors_levels_ref(padded, xys, angs),
                    "brief_level (corner keypoints, an empty image)")
    log(f"brief_level {len(padded)} images, image {mid} without keypoints, corner "
        f"keypoints on the first and last: words equal")


def check_frame_launches(imgs, per_level, fast_rec) -> dict:
    """One frame's 16 level images with each level's own keypoints, the
    shape the per-level path gives both kernels: every image through the
    one multi-image launch and singly, exact; the one launch timed beside
    its twin on the same inputs and beside the 16 single launches it
    replaces.  Adds the ``frame_*`` keys to ``fast_rec`` (whose own shape
    is the canvas) and returns brief_level's record, taken at this shape."""
    xys = [p[0] for p in per_level]
    angs = [p[3] for p in per_level]
    padded = [p[4] for p in per_level]
    for i, (img, score) in enumerate(zip(imgs, kernels.fast_score_maps(imgs))):
        fast_err(img, score, f"level image {i} of the frame's one launch")
        fast_err(img, kernels.fast_score_map(img), f"level image {i} alone")
    err = brief_words_err(kernels.brief_descriptors_levels(padded, xys, angs),
                          kernels.brief_descriptors_levels_ref(padded, xys, angs),
                          "brief_level (the frame's one launch)")
    n_kp = sum(k.shape[0] for k in xys)
    log(f"frame of {len(imgs)} level images, {n_kp} keypoint slots, one launch "
        f"each kernel: fast_score max|diff| 0.0 on every image, brief_level "
        f"words equal")

    counts = [k.shape[0] for k in xys]
    xy_all = torch.cat(xys)
    cs = [tuple(t.contiguous() for t in desc_ops.cos_sin(a)) for a in angs]
    cos_all, sin_all = (torch.cat(t) for t in zip(*cs))

    def brief_one():
        return kernels.brief_levels_kernel(padded, counts, xy_all, cos_all, sin_all)

    def brief_twin():
        return torch.cat([kernels.brief_level_gather(p, k, c, s)
                          for p, k, (c, s) in zip(padded, xys, cs)])

    def brief_singles():
        return [kernels.brief_level_kernel(p, k, c, s)
                for p, k, (c, s) in zip(padded, xys, cs)]

    level_rec = record(kernels.BRIEF_LEVEL, err, clocks(brief_one),
                       time_ms(brief_twin),
                       brief_bound(*((k.shape[0], p.numel()) for k, p in zip(xys, padded))),
                       f"a frame's {len(padded)} level images, {n_kp} keypoints")
    show(f"brief_level the frame's {len(padded)} images, {n_kp} keypoints, one "
         f"launch", level_rec, "words equal")
    fast_bound_frame = bound_record(
        sum(2 * i.numel() * 4 for i in imgs),
        sum(i.numel() for i in imgs) * FAST_OPS_PER_PIXEL)
    fast_rec.update(
        frame_ms=time_stream_ms(lambda: kernels.fast_score_maps_kernel(imgs)),
        frame_graph_ms=time_graph_ms(lambda: kernels.fast_score_maps_kernel(imgs)),
        frame_plain_ms=time_ms(lambda: [fast.fast_score_map(i) for i in imgs]),
        frame_bound_ms=fast_bound_frame["bound_ms"],
        frame_bound_by=fast_bound_frame["bound_by"])
    # brief_level's own record is the frame's launch
    level_rec.update(
        frame_ms=level_rec["stream_ms"], frame_graph_ms=level_rec["graph_ms"],
        frame_plain_ms=level_rec["plain_ms"], frame_bound_ms=level_rec["bound_ms"],
        frame_bound_by=level_rec["bound_by"])
    for rec, singles, wrapper in (
            (fast_rec, lambda: [kernels.fast_score_maps_kernel([i]) for i in imgs],
             lambda: kernels.fast_score_maps(imgs)),
            (level_rec, brief_singles,
             lambda: kernels.brief_descriptors_levels(padded, xys, angs))):
        rec["frame_singles_ms"] = time_stream_ms(singles, n=50)
        rec["frame_singles_graph_ms"] = time_graph_ms(singles, n=4)
        rec["frame_wrapper_ms"] = time_stream_ms(wrapper)
        log(f"{rec['name']}  the frame's {len(imgs)} images: one launch "
            f"{rec['frame_ms']:.5f} ms in a stream, {rec['frame_graph_ms']:.5f} ms "
            f"in a graph, through the public wrapper {rec['frame_wrapper_ms']:.5f} "
            f"ms in a stream (twin {rec['frame_plain_ms']:.4f} ms, bound "
            f"{rec['frame_bound_ms']:.5f} ms, {rec['frame_bound_by']}); one launch "
            f"an image {rec['frame_singles_ms']:.5f} ms in a stream, "
            f"{rec['frame_singles_graph_ms']:.5f} ms in a graph")
    return level_rec


def pose_opt_bound(n: int, rounds: int, iters: int) -> dict:
    """Every iteration's two passes over the edges, a gate a round and the
    final pass; the inputs read once, the outputs written once."""
    ops = n * (rounds * iters * (POSE_OPS_PASS1 + POSE_OPS_PASS2)
               + (rounds + 1) * POSE_OPS_GATE)
    return bound_record(n * POSE_BYTES_PER_EDGE + 64 + 20 + 64 + 4, ops)


def check_pose_opt(cfg, device) -> dict:
    """K4 against its twin on the same card tensors at the path's two
    shapes; returns the record at the cells' 2048 slots, with the 8000-
    feature frame's under ``dense``.  The kernel sums in another order, so
    the pose agrees to float32 rounding and an edge within 1% of the gate
    may fall on either side (tests/test_torch_kernels.py's tolerances)."""
    rounds, iters = cfg.ba.pose_rounds, cfg.ba.pose_iters_per_round

    def one(n: int, what: str) -> dict:
        args = pose_opt.synthetic_problem(17, n, noise_px=0.5, outlier_frac=0.2,
                                          active_frac=0.4, device=device)
        got = pose_opt.pose_optimization(*args, rounds=rounds, iters=iters)
        want = pose_opt.pose_optimization_ref(*args, rounds, iters)
        err = float((got.Tcw - want.Tcw).abs().max())
        near = ((want.chi2 - pose_opt.CHI2_STEREO).abs()
                <= 0.01 * pose_opt.CHI2_STEREO) & args[4]
        off = int(((got.inliers != want.inliers) & ~near).sum())
        d_in = abs(int(got.num_inliers) - int(want.num_inliers))
        require(err < 1e-4, f"pose_opt at {n} edges: Tcw off its twin's by {err}")
        require(off == 0 and d_in <= int(near.sum()),
                f"pose_opt at {n} edges: {off} inlier flags differ away from "
                f"the gate, num_inliers {int(got.num_inliers)} against "
                f"{int(want.num_inliers)}")
        rec = record(
            kernels.POSE_OPT, err,
            clocks(lambda: kernels.pose_opt_kernel(*args, rounds, iters,
                                                   pose_opt.CHI2_STEREO)),
            time_ms(lambda: pose_opt.pose_optimization_ref(*args, rounds, iters),
                    reps=5),
            pose_opt_bound(n, rounds, iters), what)
        show(f"pose_opt {what}", rec,
             f"max|dTcw| {err:.2e}, inliers {int(got.num_inliers)} (twin "
             f"{int(want.num_inliers)}, {int(near.sum())} edges near the gate)")
        return rec

    n = cfg.orb.max_keypoints
    rec = one(n, f"{n} edges ({cfg.orb.n_features} features), 40% active, "
                 f"20% outliers, {rounds} x {iters} iterations")
    dense = dataclasses.replace(cfg.orb, n_features=bench.N_FEATURES * bench.DENSITY)
    rec["dense"] = one(dense.max_keypoints, f"{dense.max_keypoints} edges "
                       f"({dense.n_features} features)")
    return rec


def check_kernels(seq, cfg, device) -> list:
    """Phase 2: each kernel against its twin on the frame's own tensors.
    Returns one record per kernel, at the shape its path gives it: the
    canvas for fast_score and brief_canvas (the atlas path), a frame's 16
    level images in one launch for brief_level (the per-level path), a
    frame's keypoint slots for pose_opt."""
    orb = cfg.orb
    left = torch.as_tensor(seq.left[0], device=device).to(torch.float32)
    right = torch.as_tensor(seq.right[0], device=device).to(torch.float32)
    levels_l = pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels)
    levels_r = pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels)
    kp = atlas.atlas_keypoints(left, right, orb, levels_l, levels_r)
    canvas = kp.canvas
    log(f"canvas {tuple(canvas.shape)}, keypoint slots {kp.cxy.shape[0]}, "
        f"valid {int(kp.valid.sum())}")

    imgs = [level.contiguous() for level in levels_l + levels_r]
    last = orb.n_levels - 1
    fast_rec = check_fast(canvas, "canvas")
    check_fast(imgs[0], "level 0")
    check_fast(imgs[last], f"level {last}")
    check_fast_awkward(device)

    canvas_rec = check_brief_canvas(kp, f"{kp.cxy.shape[0]} keypoints")
    check_brief_canvas_edges(kp, device)
    # 8000 keypoints a stereo frame (OrbConfig(n_features=4000)): two waves
    # of warps on the card instead of one; a log line, not the path's record
    orb_dense = dataclasses.replace(orb, n_features=2 * orb.n_features)
    kp_dense = atlas.atlas_keypoints(left, right, orb_dense, levels_l, levels_r)
    canvas_rec["dense"] = check_brief_canvas(
        kp_dense, f"{kp_dense.cxy.shape[0]} keypoints (n_features="
        f"{orb_dense.n_features})")
    log_brief_canvas_sass()

    # every level image's keypoints, angles and padded blurred image, as
    # the per-level extractor makes them
    per_level = [level_keypoints(img, kernels.fast_score_map(img), orb,
                                 i % orb.n_levels)
                 for i, img in enumerate(imgs)]
    check_brief_level(per_level[0][4], per_level[0][0], per_level[0][3], 0)
    check_brief_level(per_level[last][4], per_level[last][0], per_level[last][3], last)
    check_brief_corners([p[4] for p in per_level], [p[0] for p in per_level],
                        [p[3] for p in per_level], device)
    level_rec = check_frame_launches(imgs, per_level, fast_rec)
    return [fast_rec, canvas_rec, level_rec, check_pose_opt(cfg, device)]


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
STAGES = ("perframe.track", "kf.insert_total", "kf.maintain", "kf.local_ba",
          "kf.loop", "kf.gba_slice")
ASYNC_STAGES = ("perframe.track", "async.dispatch", "async.read", "async.commit",
                "kf.insert_total", "kf.snapshot_read", "kf.maintain_dispatch",
                "kf.maintain_apply", "kf.ba_dispatch", "kf.ba_apply", "kf.loop",
                "kf.gba_slice")
BA_STAGES = ("ba.assemble", "ba.solve")
WINDOW_STAGES = ("window.dispatch", "window.read", "window.commit_total",
                 "window.retrack", "perframe.track", "kf.insert_total",
                 "kf.maintain", "kf.local_ba", "kf.maintain_dispatch",
                 "kf.maintain_apply", "kf.ba_dispatch", "kf.ba_apply")


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


def run_system(seq, cfg, device, n_frames: int, launches: dict,
               unused: tuple, expected: tuple = None,
               pipelined: bool = False) -> dict:
    """Phases 5 to 8: ``System.track_stereo`` (or, with ``pipelined``,
    ``System.track_stereo_async`` and ``flush_async``) over the first
    ``n_frames`` frames of ``seq`` in the default configuration (loop
    closing on), then ``shutdown``.
    ``launches`` maps a kernel's name to its launches per frame; kernels
    in ``unused`` must not have launched; ``expected`` is the run's
    (keyframes, triangulated landmarks), which exact kernels cannot
    change.  The pipelined run also records, for every dispatch, the
    synchronizing CUDA calls PyTorch reports inside it."""
    which = f"System(use_atlas={cfg.orb.use_atlas}" + \
        (", pipelined)" if pipelined else ")")
    system = System(cfg, device, keyframe_capacity=256)
    syncs = watch_dispatch_syncs(system) if pipelined else None
    track = system.track_stereo_async if pipelined else system.track_stereo
    kernels.reset_launch_counts()
    trace.drain()
    trace.enable()
    t_first = None
    t0 = time.perf_counter()
    for i in range(n_frames):
        track(seq.left[i], seq.right[i], seq.timestamps[i])
        if t_first is None:
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
    if pipelined:
        system.flush_async()
    system.shutdown()
    elapsed = time.perf_counter() - t0
    trace.disable()
    counts = kernels.launch_counts()
    pose_spans = sum(1 for sp in trace.drain().spans if sp.name == "track.pose_opt")
    if device.type == "cuda":
        require(pose_spans > 0 and counts["pose_opt"] == pose_spans,
                f"{which}: pose_opt launched {counts['pose_opt']} times in "
                f"{pose_spans} track.pose_opt spans")
    # frame 0 initializes (state OK asserted by the keyframe checks below)
    states = [st["state"] for st in system.stats]
    require(len(states) == n_frames - 1, f"{which}: {len(states)} tracked frames")

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
        f"{sum(1 for r in maintains if r['fallback'])}, launches {counts}, "
        f"track.pose_opt spans {pose_spans}")
    for label, times, n_of in (
            [(k, system.times, system.time_counts)
             for k in (ASYNC_STAGES if pipelined else STAGES)]
            + [(k, system.map.times, None) for k in BA_STAGES]):
        n = n_of[label] if n_of is not None else n_ba
        if n:
            log(f"  {label}: {1e3 * times[label] / n:.2f} ms each over {n} calls")
    log(f"  BA counters: {dict(system.map.counters)}; local BA sizes: "
        f"{[(r['n_cams'], r['n_points'], r['n_obs']) for r in ba_runs if r.get('ran')]}")
    loops = log_loop_stage(which, system)
    require(all(s == "OK" for s in states),
            f"{which}: frame states {sorted(set(states))}")
    require("sync:weak" not in system.events, f"{which}: weak tracking")
    require("async:rescue" not in system.events, f"{which}: a frame was rescued")
    require(system.loop_closer is not None, f"{which}: no loop closer")
    require(loops["closed"] == 0,
            f"{which}: a loop closed on a sequence that never revisits a place")
    require(loops["calls"] == n_kfs - 1,
            f"{which}: the loop stage ran {loops['calls']} times for "
            f"{n_kfs} keyframes")
    if pipelined:
        require(not system._async_q and not system._maint_pipe
                and not system._maint_queue, f"{which}: work left in flight")
        report_dispatch_syncs(which, syncs)
    require(drift < MAX_DRIFT, f"{which}: drift {drift:.4f} >= {MAX_DRIFT}")
    require(n_kfs > 1, f"{which}: {n_kfs} keyframes")
    require(n_ba >= 1, f"{which}: local BA never ran")
    require(n_new > 0, f"{which}: the maintenance step created no landmark")
    if expected is not None:
        require((n_kfs, n_new) == expected,
                f"{which}: {n_kfs} keyframes and {n_new} triangulated landmarks, "
                f"expected {expected}")
    for name, per_frame in launches.items():
        require(counts[name] == per_frame * n_frames,
                f"{which}: {name} launched {counts[name]} times over "
                f"{n_frames} frames, expected {per_frame} per frame")
    for name in unused:
        require(counts[name] == 0, f"{which}: {name} launched {counts[name]} times")
    return dict(counts=counts, fps=fps, ate=ate, system=system)


def _sync_watched(real, bucket: list):
    """``real`` run under PyTorch's sync debug mode; each call appends to
    ``bucket`` the source lines of the synchronizing calls reported."""
    def watched(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                out = real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        bucket.append([f"{os.path.relpath(w.filename)}:{w.lineno}"
                       for w in caught if "ynchroniz" in str(w.message)])
        return out
    return watched


def watch_dispatch_syncs(system) -> dict:
    """Watch every dispatch of the pipelined schedule for synchronizing
    CUDA calls: the frame's (``_dispatch_chain``) and, inside the
    non-blocking maintenance queue, each keyframe's maintenance dispatch
    (``LocalMapper.maintain_dispatch``) and local-BA dispatch
    (``SlamMap.local_ba(split=True)``).  The queue's flush
    (``blocking=True``) and its loop stage, which read by design, are not
    watched.  Returns the per-dispatch lists, keyed by stage."""
    collected = dict(chain=[], maintain_dispatch=[], ba_dispatch=[])
    system._dispatch_chain = _sync_watched(system._dispatch_chain,
                                           collected["chain"])
    real_queue = system._run_maintenance_queue

    def queue(blocking: bool = True):
        if blocking or system.local_mapper is None:
            return real_queue(blocking)
        lmapper, smap = system.local_mapper, system.map
        real_ba = smap.local_ba
        lmapper.maintain_dispatch = _sync_watched(
            lmapper.maintain_dispatch, collected["maintain_dispatch"])
        watched_ba = _sync_watched(real_ba, collected["ba_dispatch"])
        smap.local_ba = lambda kf, split=False: (
            watched_ba(kf, split=True) if split else real_ba(kf, split))
        try:
            return real_queue(blocking)
        finally:
            del lmapper.maintain_dispatch, smap.local_ba

    system._run_maintenance_queue = queue
    return collected


def report_dispatch_syncs(which: str, syncs: dict, main: str = "chain") -> None:
    """Nothing may read back, or wait for the stream, inside a dispatch:
    the frame's program has to stay in flight behind the host.  Fails with
    the source lines PyTorch reports (a read-back, or an upload from
    pageable memory, which waits for the stream's earlier work)."""
    bad = []
    for stage, per_call in syncs.items():
        counts = [len(x) for x in per_call]
        where = sorted({w for x in per_call for w in x})
        log(f"  synchronizing CUDA calls inside {stage}: "
            + (f"{min(counts)}..{max(counts)} a dispatch over {len(counts)} "
               f"dispatches" if counts else "no dispatch")
            + (f", from {where}" if where else ""))
        bad += [f"{stage}: {w}" for w in where]
    require(bool(syncs[main]), f"{which}: no frame was dispatched")
    require(not bad, f"{which}: synchronizing calls inside a dispatch at {bad}")


def log_loop_stage(which: str, system) -> dict:
    """The loop stage of a run: calls, closures, the loop closer's stage
    times and its Sim3 ladder's events."""
    lc = system.loop_closer
    calls = [e for e in system.events if isinstance(e, tuple) and e[0] == "loop"]
    if lc is None:
        return dict(calls=len(calls), closed=0)
    ladder = [e for e in lc.events if isinstance(e, tuple)]
    checks = [e for e in lc.events if isinstance(e, str)]
    log(f"  loop stage ({which}): {len(calls)} calls, loops closed "
        f"{lc.n_loops_closed}, rejected {lc.n_loops_rejected}, fused "
        f"{lc.n_loops_fused}, loop edges {dict(system.map.loop_edges)}")
    for label, t in sorted(lc.times.items()):
        log(f"    {label}: {1e3 * t:.2f} ms in all")
    log(f"    Sim3 ladder events (kf, candidate, stage, count): {ladder}")
    if checks:
        log(f"    {checks}")
    return dict(calls=len(calls), closed=lc.n_loops_closed)


def loop_ates(system, seq) -> tuple:
    """ATE of the raw per-frame poses and of the corrected trajectory."""
    gt = seq.poses_wc[: len(system.trajectory)]
    raw = ate_rmse(np.linalg.inv(np.stack(system.trajectory).astype(np.float64)), gt)
    corr = ate_rmse(np.linalg.inv(system.corrected_trajectory().astype(np.float64)), gt)
    return raw, corr


def run_loop_full_width(seq, device) -> dict:
    """Phase 8: the full-width loop sequence through the pipelined
    schedule, loop closing on."""
    n = seq.left.shape[0]
    which = f"loop {WIDTH}x{HEIGHT} x {n} frames, pipelined"
    system = System(config_of(seq, N_FEATURES), device, keyframe_capacity=256)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n):
        system.track_stereo_async(seq.left[i], seq.right[i], seq.timestamps[i])
    system.flush_async()
    system.shutdown()
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    states = [st["state"] for st in system.stats]
    ate_raw, ate_corr = loop_ates(system, seq)
    log(f"{which}: {elapsed:.2f} s ({n / elapsed:.3f} frames/s with the first "
        f"frame), keyframes {system.map.keyframes.n}, landmarks alive "
        f"{int(system.map.landmarks.alive.sum())}, states "
        f"{ {st: states.count(st) for st in set(states)} }, rescues "
        f"{sum(1 for e in system.events if e == 'async:rescue')}, ATE raw "
        f"{ate_raw:.4f} m, corrected {ate_corr:.4f} m over "
        f"{np.linalg.norm(np.diff(seq.poses_wc[:, :3, 3], axis=0), axis=1).sum():.2f} m, "
        f"launches {counts}")
    for label in ASYNC_STAGES:
        k = system.time_counts[label]
        if k:
            log(f"  {label}: {1e3 * system.times[label] / k:.2f} ms each over {k} calls")
    loops = log_loop_stage(which, system)
    require(len(system.trajectory) == n and len(states) == n - 1,
            f"{which}: a frame was not tracked")
    require(bool(np.isfinite(system.corrected_trajectory()).all()),
            f"{which}: non-finite pose")
    require(not system._async_q and not system._maint_pipe
            and not system._maint_queue, f"{which}: work left in flight")
    require(loops["calls"] == system.map.keyframes.n - 1,
            f"{which}: the loop stage ran {loops['calls']} times")
    for name in ATLAS_KERNELS:
        require(counts[name] == n, f"{which}: {name} launched {counts[name]} "
                                   f"times over {n} frames")
    return dict(ate_raw=ate_raw, ate_corr=ate_corr, closed=loops["closed"])


def run_loop_tier1(seq, device) -> dict:
    """Phase 9: tests/conftest.py::full_loop_run's sequence and System
    through ``track_stereo``; the JAX package's loop gates, the roll-back
    of a garbage Sim3, and global BA's cg engine against its dense one."""
    n = seq.left.shape[0]
    which = f"loop 512x160 x {n} frames"
    system = System(config_of(seq, TIER1_LOOP["n_features"]), device)
    t0 = time.perf_counter()
    for i in range(n):
        system.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
    system.shutdown()
    elapsed = time.perf_counter() - t0
    lc = system.loop_closer
    ate_raw, ate_corr = loop_ates(system, seq)
    weak = sum(1 for st in system.stats if st["inliers"] < 10)
    log(f"{which}: {elapsed:.2f} s ({n / elapsed:.3f} frames/s), keyframes "
        f"{system.map.keyframes.n}, ATE raw {ate_raw:.4f} m, corrected "
        f"{ate_corr:.4f} m, frames under 10 inliers {weak}")
    for label in STAGES:
        k = system.time_counts[label]
        if k:
            log(f"  {label}: {1e3 * system.times[label] / k:.2f} ms each over {k} calls")
    loops = log_loop_stage(which, system)
    require(loops["closed"] >= 1, f"{which}: no loop closed")
    require(any(v for v in system.map.loop_edges.values()),
            f"{which}: no loop edge recorded")
    require(ate_corr < 0.6, f"{which}: corrected ATE {ate_corr:.4f} m >= 0.6 m")

    # tests/test_loop_closing.py::TestCorrectionAcceptGate on this state
    ks, lm = system.map.keyframes, system.map.landmarks
    kf = ks.n - 1
    pre_Tcw = ks.Tcw[: ks.n].copy()
    pre_closed, pre_rejected = lc.n_loops_closed, lc.n_loops_rejected
    bad = ks.Tcw[kf].copy()
    c, s = np.cos(0.35), np.sin(0.35)
    bad[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) @ bad[:3, :3]
    bad[0, 3] += 6.0
    lc.correct(kf, 0, (bad[:3, :3].copy(), bad[:3, 3].copy(), 1.0), match_map={})
    delta = float(np.abs(ks.Tcw[: ks.n] - pre_Tcw).max())
    log(f"  garbage Sim3 at keyframe {kf}: {lc.events[-1]}, rejected "
        f"{lc.n_loops_rejected - pre_rejected}, largest pose change {delta:.2e}")
    require(lc.n_loops_rejected == pre_rejected + 1 and lc.n_loops_closed == pre_closed,
            f"{which}: the garbage Sim3 was not rejected")
    require(delta < 1e-4, f"{which}: geometry not restored ({delta})")

    # global BA: the cg engine against the dense one from the same state
    live = [k for k in range(ks.n) if ks.alive[k]]
    pnt = system.map.core.observed_landmarks(lm.n)
    snap_Tcw, snap_pos = ks.Tcw[: ks.n].copy(), lm.pos[: lm.n].copy()
    out = {}
    for engine in ("dense", "cg"):
        ks.Tcw[: ks.n], lm.pos[: lm.n] = snap_Tcw, snap_pos
        t0 = time.perf_counter()
        info = system.map._run_ba(live, len(live), pnt, 2, 0, False, engine=engine)
        out[engine] = (ks.Tcw[: ks.n].copy(), time.perf_counter() - t0, info)
    centres = {e: -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
               for e, (T, _, _) in out.items()}
    gap = float(np.linalg.norm(centres["cg"] - centres["dense"], axis=1).max())
    moved = float(np.linalg.norm(
        centres["dense"] + np.einsum("kji,kj->ki", snap_Tcw[:, :3, :3],
                                     snap_Tcw[:, :3, 3]), axis=1).max())
    log(f"  global BA, 2 iterations over {len(live)} live keyframes, "
        f"{out['dense'][2].get('n_points')} points, {out['dense'][2].get('n_obs')} "
        f"observations: dense {1e3 * out['dense'][1]:.1f} ms, cg "
        f"{1e3 * out['cg'][1]:.1f} ms; largest camera move {moved:.4f} m, "
        f"cg against dense {gap:.5f} m")
    require(out["dense"][2]["ran"] and out["cg"][2]["ran"], f"{which}: a BA did not run")
    require(gap < 0.02, f"{which}: cg and dense global BA differ by {gap:.4f} m")
    return dict(ate_corr=ate_corr, closed=loops["closed"], system=system)


def run_kidnap(seq, system, n_frames: int) -> None:
    """After the pipelined run: two frames of seeded noise through
    ``track_stereo_async`` destroy tracking (the commit hands the first to
    the per-frame machine, the second goes there directly), then frame 5
    again: relocalization (BoW candidates, EPnP RANSAC, projection rescue)
    must bring the state back to ``OK`` within 0.5 m of the truth."""
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 255, seq.left[0].shape).astype(np.float32)
    t0 = time.perf_counter()
    for _ in range(2):
        system.track_stereo_async(noise, noise, 0.0)
    system.track_stereo_async(seq.left[5], seq.right[5], 99.0)
    system.shutdown()
    elapsed = time.perf_counter() - t0
    states = [st["state"] for st in system.stats[n_frames - 1:]]
    gt = np.linalg.inv(seq.poses_wc[5])
    err = float(np.linalg.norm(system.Tcw[:3, 3] - gt[:3, 3]))
    log(f"kidnap: states over the two noise frames and the return {states}, "
        f"final state {system.state}, position error {err:.4f} m, relocalized "
        f"at frame {system.last_reloc_frame} of {system.frame_id}, rescue "
        f"events {sum(1 for e in system.events if e == 'async:rescue')}, "
        f"{elapsed:.2f} s")
    require(len(system.trajectory) == n_frames + 3, "kidnap: a frame was lost")
    require("async:rescue" in system.events, "kidnap: no commit rescued a frame")
    require("WEAK" in states, f"kidnap: noise did not break tracking: {states}")
    require(system.last_reloc_frame >= n_frames,
            "kidnap: relocalization did not answer")
    require(system.state == "OK", f"kidnap: state {system.state}")
    require(err < 0.5, f"kidnap: position error {err:.3f} m")


def run_window(seq, cfg, device, n_frames: int, fed: bool, ate_per_frame: float,
               factor: float, floor: float) -> dict:
    """Phase 10: ``track_stereo_window`` (or, with ``fed``, ``window_feed``
    and ``window_flush``) over ``n_frames`` in windows of ``WINDOW``, then
    ``shutdown``.  Every dispatch is watched for synchronizing CUDA calls;
    the frames each dispatch scans and the calls of ``track_stereo`` are
    counted, since each launches the atlas kernels once a frame.  The ATE
    must meet the JAX package's gate (tests/test_system.py::
    TestWindowedTracking: under ``factor`` x the per-frame ATE or
    ``floor``), and every committed rotation must be orthonormal."""
    which = "System.window_feed" if fed else "System.track_stereo_window"
    system = System(cfg, device, keyframe_capacity=256)
    syncs = []
    scanned, per_frame = [], []
    dispatch = _sync_watched(system._dispatch_window, syncs)

    def counted_dispatch(lefts, rights, timestamps):
        scanned.append(len(timestamps))
        return dispatch(lefts, rights, timestamps)

    real_track = system.track_stereo

    def counted_track(left, right, timestamp):
        per_frame.append(timestamp)
        return real_track(left, right, timestamp)

    system._dispatch_window, system.track_stereo = counted_dispatch, counted_track
    kernels.reset_launch_counts()
    returned = []
    t0 = time.perf_counter()
    for w0 in range(0, n_frames, WINDOW):
        w = slice(w0, min(w0 + WINDOW, n_frames))
        feed = system.window_feed if fed else system.track_stereo_window
        returned.extend(feed(seq.left[w], seq.right[w], seq.timestamps[w]))
    if fed:
        returned.extend(system.window_flush())
    system.shutdown()
    elapsed = time.perf_counter() - t0
    counts = kernels.launch_counts()
    poses = system.corrected_trajectory()
    ate, drift, length = drift_of(list(poses), seq, n_frames)
    events = Counter(e for e in system.events if isinstance(e, str))
    fps = n_frames / elapsed
    log(f"{which} (W={WINDOW}): {n_frames} frames in {elapsed:.2f} s, "
        f"{fps:.3f} frames/s with the first; ATE {ate:.4f} m over {length:.2f} m "
        f"(drift {100 * drift:.3f}%) against {ate_per_frame:.4f} m per frame, "
        f"keyframes {system.map.keyframes.n}, {sum(scanned)} frames scanned in "
        f"{len(scanned)} dispatches, {len(per_frame)} through track_stereo, "
        f"events {dict(sorted(events.items()))}, launches {counts}")
    for label in WINDOW_STAGES:
        k = system.time_counts[label]
        if k:
            log(f"  {label}: {1e3 * system.times[label] / k:.2f} ms each over {k} calls")
    report_dispatch_syncs(which, dict(window=syncs), main="window")
    require(len(returned) == n_frames, f"{which}: {len(returned)} poses returned")
    require(len(system.trajectory) == n_frames, f"{which}: a frame was not tracked")
    require(bool(np.isfinite(poses).all()) and bool(np.isfinite(np.stack(returned)).all()),
            f"{which}: non-finite pose")
    require(system._pending_window is None and not system._maint_pipe
            and not system._maint_queue, f"{which}: work left in flight")
    for name in ATLAS_KERNELS:
        want = sum(scanned) + len(per_frame)
        require(counts[name] == want, f"{which}: {name} launched {counts[name]} "
                                      f"times, {want} frames built")
    require(system.map.keyframes.n >= 3,
            f"{which}: {system.map.keyframes.n} keyframes")
    R = np.stack(system.trajectory).astype(np.float64)[:, :3, :3]
    rot_err = float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())
    gate = max(factor * ate_per_frame, floor)
    log(f"  ATE {ate:.4f} m against the JAX package's gate max({factor} x "
        f"{ate_per_frame:.4f}, {floor}) = {gate:.4f} m; committed rotations "
        f"|R R^T - I| <= {rot_err:.2e}")
    require(rot_err < 1e-5, f"{which}: a committed rotation is {rot_err:.2e} "
                            "from orthonormal")
    require(ate < gate, f"{which}: ATE {ate:.4f} m against the gate {gate:.4f} m")
    return dict(ate=ate, fps=fps)


def run_checkpoint(system, seq) -> None:
    """Phase 11: the map of phase 5's System saved and loaded on its
    device, compared, swapped in, and tracked on."""
    m = system.map
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        t0 = time.perf_counter()
        checkpoint.save_map(m, path)
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        m2 = checkpoint.load_map(system.cfg, system.device, path)
        t_load = time.perf_counter() - t0
    nk, nl = m.keyframes.n, m.landmarks.n
    require((m2.keyframes.n, m2.landmarks.n) == (nk, nl),
            f"checkpoint: {m2.keyframes.n} keyframes, {m2.landmarks.n} landmarks "
            f"loaded of {nk}, {nl}")
    for what, a, b in (("poses", m2.keyframes.Tcw[:nk], m.keyframes.Tcw[:nk]),
                       ("positions", m2.landmarks.pos[:nl], m.landmarks.pos[:nl]),
                       ("observations", m2.keyframes.obs_lm[:nk], m.keyframes.obs_lm[:nk])):
        require(np.array_equal(a, b), f"checkpoint: {what} differ")
    obs = m2.keyframes.obs_lm[:nk]
    ca, cb, cw = m2.core.covis_edges()
    for a, b, w in zip(ca.tolist(), cb.tolist(), cw.tolist()):
        na, nb = Counter(obs[a][obs[a] >= 0].tolist()), Counter(obs[b][obs[b] >= 0].tolist())
        require(w == sum(na[k] * nb[k] for k in na.keys() & nb.keys()),
                f"checkpoint: covisibility {a}-{b} is not the recount")
    system.map = m2
    if system.local_mapper is not None:
        system.local_mapper.map = m2
    if system.loop_closer is not None:
        system.loop_closer.map = m2
    last = seq.left.shape[0] - 1
    states = []
    for k in range(4):
        system.track_stereo(seq.left[last], seq.right[last], seq.timestamps[last] + 0.1 * (k + 1))
        states.append(system.state)
    system.shutdown()
    inliers = system.stats[-1]["inliers"]
    log(f"checkpoint: {nk} keyframes, {nl} landmarks, {len(ca)} covisibility edges, "
        f"{size} bytes; save {t_save:.3f} s, load on {system.device} {t_load:.3f} s; "
        f"resumed on the loaded map (the last frame four times): states {states}, "
        f"inliers {[st['inliers'] for st in system.stats[-4:]]}")
    require(all(st in ("OK", "MARGINAL") for st in states), f"checkpoint: states {states}")
    require(inliers > 30, f"checkpoint: {inliers} inliers on the last frame")


def synced(fn):
    """``fn()`` between two ``torch.cuda.synchronize``: (result, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def median_centre_err(cam_Tcw, true_c) -> float:
    cam = cam_Tcw.cpu().numpy() if isinstance(cam_Tcw, torch.Tensor) else cam_Tcw
    c = gba_tiling.centres(cam[:, :3, :3], cam[:, :3, 3])
    return float(np.median(np.linalg.norm(c - true_c, axis=1)))


def sharded_ba(prob, mesh):
    """The sharded CG BA of the tiled ``prob`` over ``mesh``, its shards
    placed first: (Tcw, seconds of the solve)."""
    shards = dist_ba.shard_problem(dryrun.group_for_shards(prob, mesh.n_shards), mesh)
    return synced(lambda: dist_ba.distributed_bundle_adjust_cg(
        shards, mesh, n_cam=prob.cam_Tcw.shape[0], **GBA_ITERS)[0])


def run_sharded(tiled, loop_system, device, smi: str) -> None:
    """Phase 12: the sharded engines on the one card.  Phase 5's map tiled
    as tests/test_dist_gba_scale.py tiles its own, through the sharded CG
    BA on SHARDS shards of the card and on an NCCL group of world size 1,
    against the single-device CG; global BA's dist rung on phase 9's map
    beside the cg and dense rungs; the sharded essential graph against the
    single-device CG solver.  No scaling is claimed: every shard is on
    the one card."""
    prob, true_c = tiled.prob, tiled.true_centres
    C, O = prob.cam_Tcw.shape[0], prob.obs_cam.shape[0]
    err_start = median_centre_err(prob.cam_Tcw.numpy(), true_c)
    on_card = ba.BAProblem(*(t.to(device) for t in prob))
    one, t_one = synced(lambda: ba_cg.bundle_adjust_cg(on_card, **GBA_ITERS).cam_Tcw)
    mesh = dist_ba.device_mesh(device, SHARDS)
    shard_cam, t_shard = sharded_ba(prob, mesh)
    multihost.initialize(f"tcp://localhost:{dryrun.free_port()}", 1, 0, device,
                         timeout=datetime.timedelta(seconds=300))
    try:
        gmesh = multihost.global_mesh()
        require(gmesh.n_shards == torch.cuda.device_count(),
                f"NCCL mesh of {gmesh.n_shards} shards")
        # the communicator is made at the first collective: not the solve's
        synced(lambda: gmesh.reduce([torch.ones(1, device=device)]))
        nccl_cam, t_nccl = sharded_ba(prob, gmesh)
    finally:
        multihost.shutdown()
    e_one = median_centre_err(one, true_c)
    which = f"sharded CG BA, {C} cameras, {O} observations ({tiled.copies} copies)"
    log(f"{which}, {GBA_ITERS} on {smi}: median centre error start "
        f"{err_start:.5f} m; one device {e_one:.5f} m in {1e3 * t_one:.1f} ms")
    for name, cam, t in ((f"{SHARDS} shards on {device}", shard_cam, t_shard),
                         ("NCCL group of world size 1", nccl_cam, t_nccl)):
        err = median_centre_err(cam, true_c)
        gap = float(torch.abs(cam[:, :3, 3] - one[:, :3, 3]).max())
        log(f"  {name}: {err:.5f} m in {1e3 * t:.1f} ms; largest translation "
            f"difference from one device {gap:.2e} m")
        require(bool(torch.isfinite(cam).all()), f"{which}, {name}: non-finite pose")
        require(err < 1.5 * e_one + 1e-3,
                f"{which}, {name}: {err:.5f} m against {e_one:.5f} m on one device")
        require(err < 0.8 * err_start,
                f"{which}, {name}: {err:.5f} m against {err_start:.5f} m at the start")
        require(gap < SHARD_T_TOL, f"{which}, {name}: translations {gap:.2e} m "
                f"from one device's")

    # global BA's rungs on phase 9's map, from one state
    m = loop_system.map
    ks, lm = m.keyframes, m.landmarks
    live = [k for k in range(ks.n) if ks.alive[k]]
    pnt = m.core.observed_landmarks(lm.n)
    snap_Tcw, snap_pos = ks.Tcw[: ks.n].copy(), lm.pos[: lm.n].copy()
    out = {}
    for name, engine, rung_mesh in (("dense", "dense", None), ("cg", "cg", None),
                                    ("dist", "dist", None),
                                    (f"dist {SHARDS} shards", "dist", mesh)):
        ks.Tcw[: ks.n], lm.pos[: lm.n] = snap_Tcw, snap_pos
        info, t = synced(lambda: m._run_ba(live, len(live), pnt, 2, 0, False,
                                           engine=engine, mesh=rung_mesh))
        require(info["ran"], f"global BA {name}: did not run")
        out[name] = (gba_tiling.centres(ks.Tcw[: ks.n, :3, :3], ks.Tcw[: ks.n, :3, 3]), t)
    gaps = {name: float(np.linalg.norm(c - out[ref][0], axis=1).max())
            for name, (c, _) in out.items() if name.startswith("dist")
            for ref in ("cg", "dense")}
    log(f"  global BA of phase 9's map, 2 iterations over {len(live)} keyframes: "
        + ", ".join(f"{n} {1e3 * t:.1f} ms" for n, (_, t) in out.items())
        + f"; dist rungs against cg and dense at most {max(gaps.values()):.5f} m")
    require(max(gaps.values()) < 0.02, f"global BA: dist rung {gaps} m from cg / dense")

    # the sharded essential graph
    _, _, pg_args = dryrun.drift_graph(*dryrun.PG_GRAPH)
    args = [torch.from_numpy(np.asarray(a)).to(device) for a in pg_args]
    ref, t_ref = synced(lambda: optimize_pose_graph_cg(
        *args, cg_iters=dryrun.PG_CG_ITERS))
    (R, t), t_pg = synced(lambda: dryrun.solve_pose_graph(pg_args, mesh))
    dR = float(torch.abs(R - ref.R).max())
    dt = float(torch.abs(t - ref.t).max())
    log(f"  essential graph, {len(pg_args[4])} edges: one device {1e3 * t_ref:.1f} ms, "
        f"{SHARDS} shards {1e3 * t_pg:.1f} ms; largest R / t difference "
        f"{dR:.2e} / {dt:.2e}")
    require(dR < 5e-3 and dt < 5e-3, f"sharded essential graph: R {dR}, t {dt}")


def run_viewer(seq, cfg, device) -> None:
    """Phase 13: ``LiveViewer`` on port 0 over a pipelined ``System``,
    ``/state`` fetched after every frame under the sync watch: the fields
    of tests/test_viewer.py, no synchronizing CUDA call in a dispatch or
    in the viewer's thread, the atlas kernels once a frame."""
    which = f"viewer over System pipelined, {N_VIEWER_FRAMES} frames"
    system = System(cfg, device, keyframe_capacity=256)
    syncs = watch_dispatch_syncs(system)
    viewer = LiveViewer(system, port=0).start()
    base = f"http://127.0.0.1:{viewer.port}"
    state_syncs, fetch_s = [], []

    def get_state():
        t0 = time.perf_counter()
        st = json.loads(urllib.request.urlopen(f"{base}/state", timeout=60).read())
        fetch_s.append(time.perf_counter() - t0)
        return st

    fetch = _sync_watched(get_state, state_syncs)
    fields = {"points", "kf_xy", "covis", "traj", "cam", "status", "keypoints",
              "frame"}
    try:
        page = urllib.request.urlopen(f"{base}/", timeout=60).read()
        require(b"follow camera" in page, f"{which}: no page")
        kernels.reset_launch_counts()
        lengths = []
        t0 = time.perf_counter()
        for i in range(N_VIEWER_FRAMES):
            system._viewer_image = seq.left[i]
            system.track_stereo_async(seq.left[i], seq.right[i], seq.timestamps[i])
            st = fetch()
            require(fields <= set(st), f"{which}: /state after frame {i}: {sorted(st)}")
            lengths.append(len(st["traj"]))
        system.flush_async()
        elapsed = time.perf_counter() - t0
        counts = kernels.launch_counts()
        st = fetch()
        system.shutdown()
    finally:
        viewer.stop()
    log(f"{which}: {elapsed:.2f} s with a /state fetch a frame, trajectory "
        f"lengths {lengths} then {len(st['traj'])}, status {st['status']}, "
        f"{len(st['points'])} points, {len(st['keypoints'])} keypoints, launches "
        f"{counts}")
    report_dispatch_syncs(which, syncs)
    where = sorted({w for x in state_syncs for w in x})
    log(f"  synchronizing CUDA calls during the {len(state_syncs)} /state fetches: "
        f"{sum(len(x) for x in state_syncs)}" + (f", from {where}" if where else "")
        + f"; a fetch {1e3 * np.mean(fetch_s):.2f} ms on average, "
        f"{1e3 * max(fetch_s):.2f} ms at most")
    require(not where, f"{which}: the viewer synchronized at {where}")
    require(lengths == sorted(lengths), f"{which}: trajectory lengths {lengths}")
    require(st["status"]["kfs"] >= 1 and st["status"]["lms"] > 100,
            f"{which}: status {st['status']}")
    require(len(st["points"]) > 0 and st["cam"] is not None and bool(st["frame"]),
            f"{which}: empty state")
    require(len(st["traj"]) == N_VIEWER_FRAMES, f"{which}: {len(st['traj'])} poses")
    require(st["traj"][-1][1] > 3.0, f"{which}: camera at {st['traj'][-1]}")
    for name in ATLAS_KERNELS:
        require(counts[name] == N_VIEWER_FRAMES,
                f"{which}: {name} launched {counts[name]} times")


def run_renderer(ref, device, smi: str) -> None:
    """Phase 14: ``TorchRenderer`` on the card against the numpy renderer
    on the loop scene's frames, tests/test_render_jax.py's gates."""
    r = TorchRenderer(ref["planes"], ref["tex"], device)
    K = ref["K"]
    synced(lambda: r.render_tensor(ref["poses"][0], K, WIDTH, HEIGHT))   # warm
    card_s = []
    for i, (Twc, want) in zip(RENDER_FRAMES, zip(ref["poses"], ref["frames"])):
        got, t = synced(lambda: r.render_tensor(Twc, K, WIDTH, HEIGHT))
        card_s.append(t)
        d = np.abs(got.cpu().numpy().astype(np.int32) - want.astype(np.int32))
        med, frac = float(np.median(d)), float((d > 2).mean())
        log(f"renderer, loop scene frame {i} at {WIDTH}x{HEIGHT} "
            f"({len(ref['planes'])} planes): median |diff| {med}, share off by "
            f"more than 2: {frac:.5f}, largest |diff| {int(d.max())}, "
            f"{int((d > 0).sum())} of {d.size} pixels unequal")
        require(med <= 1.0 and frac < 0.02, f"renderer frame {i}: {med}, {frac}")
    log(f"  TorchRenderer {1e3 * np.mean(card_s):.2f} ms a frame on {smi} "
        f"({[round(1e3 * t, 2) for t in card_s]}); numpy on the host "
        f"{1e3 * np.mean(ref['host_s']):.1f} ms a frame, in a worker process "
        f"beside the card's phases")


def host_rss_mb() -> tuple:
    """The host process's resident set now and at its peak, in MiB."""
    with open("/proc/self/status") as f:
        now = next(int(line.split()[1]) for line in f if line.startswith("VmRSS"))
    return now / 1024, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def huber_chi2(smap) -> tuple:
    """Mean Huberized reprojection chi2 of the map's live observations
    (``SlamMap.reprojection_chi2``'s terms), over the stereo ones (those
    bundle adjustment optimizes: ``mapcore_assemble_obs`` skips every
    observation without a right-image match) and over the monocular
    ones."""
    ks, lm = smap.keyframes, smap.landmarks
    obs = ks.obs_lm[: ks.n]
    ki, fi = np.nonzero((obs >= 0) & ks.alive[: ks.n, None]
                        & lm.alive[np.maximum(obs, 0)])
    chi2, depth = smap.observation_chi2(ki, fi, obs[ki, fi])
    d = ba.HUBER_DELTA
    rho = np.where(chi2 <= d * d, chi2, 2.0 * d * np.sqrt(chi2) - d * d)
    rho = np.where(depth <= 0, 2.0 * d * 50.0, rho)
    stereo = ks.u_right[ki, fi] > 0
    return float(rho[stereo].mean()), float(rho[~stereo].mean())


def run_scale(stream, device) -> dict:
    """Phase 15: the at-scale loop through the pipelined schedule, loop
    closing on; then one explicit global BA on the final map."""
    n = stream.n_frames
    which = f"scale loop {WIDTH}x{HEIGHT} x {n} frames, pipelined"
    t0 = time.perf_counter()
    frames = [stream.frame(i) for i in range(n)]
    del stream._torch_renderer
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"{which}: rendered on the card in {time.perf_counter() - t0:.2f} s")
    system = System(eval_scale.scale_config(stream, WIDTH, HEIGHT, N_FEATURES), device)
    w0, w_len = SCALE_WATCH
    syncs, peaks, stamps = None, {}, []
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    watching = False
    for i, (left, right) in enumerate(frames):
        if i == w0:
            syncs, watching = watch_dispatch_syncs(system), True
        system.track_stereo_async(left, right, stream.timestamps[i])
        if watching and len(syncs["chain"]) == w_len:
            del system._dispatch_chain, system._run_maintenance_queue
            watching = False
        stamps.append(time.perf_counter())
        if i + 1 in SCALE_MEM_AT:
            peaks[i + 1] = torch.cuda.max_memory_allocated() / 2**20
    system.flush_async()
    system.shutdown()
    stamps[-1] = time.perf_counter()
    peaks[n] = torch.cuda.max_memory_allocated() / 2**20
    counts = kernels.launch_counts()
    first, last = eval_scale.span_rates(stamps, t0)
    ks, lm, lc = system.map.keyframes, system.map.landmarks, system.loop_closer
    alive = int(ks.alive[: ks.n].sum())
    poses = system.corrected_trajectory()
    gt = stream.poses_wc[:n]
    length = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    ate = ate_rmse(np.linalg.inv(poses.astype(np.float64)), gt)
    rss, rss_peak = host_rss_mb()
    log(f"{which}: {stamps[-1] - t0:.2f} s, frames/s {first:.3f} over the first "
        f"100 frames and {last:.3f} over the last 100; keyframes {alive} alive of "
        f"{ks.n}, landmarks {int(lm.alive.sum())} alive of {lm.n}; loops closed "
        f"{lc.n_loops_closed}, rejected {lc.n_loops_rejected}, fused "
        f"{lc.n_loops_fused}; ATE corrected {ate:.4f} m over {length:.2f} m "
        f"({100 * ate / length:.3f}%), state {system.state}, launches {counts}")
    log(f"  kf.loop {system.times['kf.loop']:.2f} s over "
        f"{system.time_counts['kf.loop']} calls, loop.correct "
        f"{lc.times['loop.correct']:.2f} s, kf.gba_slice "
        f"{system.times['kf.gba_slice']:.2f} s over "
        f"{system.time_counts['kf.gba_slice']} calls")
    for label, t in sorted(lc.times.items()):
        log(f"    {label}: {t:.3f} s in all")
    log(f"  peak device memory (MiB) after frames {peaks}; host RSS {rss:.0f} "
        f"MiB, peak {rss_peak:.0f} MiB")
    ladder = [e for e in lc.events if isinstance(e, tuple)]
    log(f"  Sim3 ladder events (kf, candidate, stage, count), last 20: {ladder[-20:]}")
    log(f"  accept checks: {[e for e in lc.events if isinstance(e, str)][-10:]}")
    require(len(system.trajectory) == n and bool(np.isfinite(poses).all()),
            f"{which}: {len(system.trajectory)} poses, or a pose not finite")
    require(system.state == "OK", f"{which}: final state {system.state}")
    require(not system._async_q and not system._maint_pipe
            and not system._maint_queue, f"{which}: work left in flight")
    for name in ATLAS_KERNELS:
        require(counts[name] == n, f"{which}: {name} launched {counts[name]} "
                                   f"times over {n} frames")
    require(alive >= SCALE_MIN_KFS, f"{which}: {alive} live keyframes")
    require(lc.n_loops_closed + lc.n_loops_rejected >= 1,
            f"{which}: the loop machinery never engaged")
    require(ate < SCALE_MAX_DRIFT * length,
            f"{which}: ATE {ate:.4f} m over {length:.2f} m")
    report_dispatch_syncs(f"{which}, from frame {w0}", syncs)
    require(not watching, f"{which}: {len(syncs['chain'])} watched dispatches")

    before = (system.map.reprojection_chi2(),) + huber_chi2(system.map)
    t0 = time.perf_counter()
    info = system.map.global_ba()
    torch.cuda.synchronize()
    t_gba = time.perf_counter() - t0
    after = (system.map.reprojection_chi2(),) + huber_chi2(system.map)
    log(f"  global BA of the final map: {t_gba:.2f} s, {info}; reprojection chi2 "
        f"(all, stereo, monocular) {tuple(round(x, 4) for x in before)} -> "
        f"{tuple(round(x, 4) for x in after)}")
    require(info.get("ran") and not info.get("rejected"),
            f"{which}: global BA {info}")
    require(info["n_cams"] > GBA_DENSE_MAX_KFS,
            f"{which}: global BA over {info['n_cams']} cameras")
    require(after[1] <= before[1],
            f"{which}: global BA raised its observations' chi2 {before[1]} -> "
            f"{after[1]}")
    return dict(counts=counts, first=first, last=last, ate=ate)


def count_built_frames() -> tuple:
    """Count ``build_stereo_frame`` calls where the bench, the ``System``
    and the tracking programs make their frames; returns (counter, undo)."""
    modules = (bench, system_mod, tracking_mod)
    real = [m.build_stereo_frame for m in modules]
    built = Counter()

    def counted(fn):
        def build(*args, **kwargs):
            built["frames"] += 1
            return fn(*args, **kwargs)
        return build

    for m, fn in zip(modules, real):
        m.build_stereo_frame = counted(fn)

    def undo():
        for m, fn in zip(modules, real):
            m.build_stereo_frame = fn
    return built, undo


def run_bench(seq, device, ate_sync: float) -> dict:
    """Phase 16: every configuration of the bench through ``run_config``,
    the default first at bench.py's own lengths and passes; then
    brief_canvas at the high-density slot count.  Returns the default
    run's launch counts and brief_canvas' high-density record."""
    built, undo = count_built_frames()
    t_phase = time.perf_counter()
    try:
        for i, (config, mode) in enumerate(BENCH_RUNS):
            which = f"bench BENCH_CONFIG={config!r} BENCH_MODE={mode}"
            n = None if i == 0 else BENCH_SHORT_FRAMES
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            built.clear()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            rec, detail = bench.run_config(config, device, n_frames=n, mode=mode,
                                           passes=3 if i == 0 else 1)
            seconds = time.perf_counter() - t0
            counts = kernels.launch_counts()
            print(json.dumps(rec), flush=True)
            log(f"  {which}: {seconds:.2f} s, frames built {built['frames']}, "
                f"launches {counts}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
            if i == 0:
                default_counts = counts
            if config in bench.TRACKING_CONFIGS:
                poses = detail.poses
            else:
                poses = detail.corrected_trajectory()
                require(len(detail.trajectory) == rec["n_frames"],
                        f"{which}: {len(detail.trajectory)} poses")
                require(not detail._async_q and not detail._maint_pipe
                        and not detail._maint_queue
                        and detail._pending_window is None,
                        f"{which}: work left in flight")
            require(bool(np.isfinite(poses).all()), f"{which}: non-finite pose")
            for name in ATLAS_KERNELS:
                require(counts[name] == built["frames"] > 0,
                        f"{which}: {name} launched {counts[name]} times for "
                        f"{built['frames']} frames built")
            require(counts["brief_level"] == 0, f"{which}: brief_level launched")
            if i == 0:
                gate = max(2.0 * ate_sync, 0.15)
                log(f"  ATE {rec['ate_rmse_m']} m against phase 7's gate "
                    f"max(2 x {ate_sync:.4f}, 0.15) = {gate:.4f} m")
                require(rec["ate_rmse_m"] < gate, f"{which}: ATE {rec['ate_rmse_m']}")
                require("async:rescue" not in rec["schedule_events"],
                        f"{which}: events {rec['schedule_events']}")
    finally:
        undo()

    orb = dataclasses.replace(config_of(seq, N_FEATURES).orb,
                              n_features=bench.DENSITY * N_FEATURES)
    left = torch.as_tensor(seq.left[0], device=device).to(torch.float32)
    right = torch.as_tensor(seq.right[0], device=device).to(torch.float32)
    kp = atlas.atlas_keypoints(
        left, right, orb, pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels),
        pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels))
    dense = check_brief_canvas(
        kp, f"{kp.cxy.shape[0]} keypoints (n_features={orb.n_features})")
    log(f"phase 16 (bench): {time.perf_counter() - t_phase:.2f} s")
    return dict(counts=default_counts, dense=dense)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build, kernels against their "
                         "twins, times) on a 2-frame sequence of the same size")
    kernels_only = ap.parse_args().kernels_only
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

    pool = None
    if not kernels_only:
        pool = concurrent.futures.ProcessPoolExecutor(
            max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    try:
        run_phases(device, smi, kernels_only, pool)
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


def run_phases(device, smi: str, kernels_only: bool, pool) -> None:
    renders = start_renders(pool) if pool is not None else None
    t0 = time.perf_counter()
    seq, cfg = make_sequence(2 if kernels_only else N_FRAMES)
    cfg_levels = dataclasses.replace(
        cfg, orb=dataclasses.replace(cfg.orb, use_atlas=False))
    log(f"rendered {seq.left.shape[0]} frames of {WIDTH}x{HEIGHT} in "
        f"{time.perf_counter() - t0:.1f} s")

    records = check_kernels(seq, cfg, device)
    if kernels_only:
        print(json.dumps({"kernels": records}))
        print(smi)
        return
    check_frame_against_cpu(seq, cfg, device)
    check_frame_against_cpu(seq, cfg_levels, device)
    tracked = run_tracker(seq, cfg, device)
    fused = run_fused_chain(seq, cfg, device, tracked["snapshot"])
    main_path = run_system(seq, cfg, device, N_FRAMES,
                           {"fast_score": 1, "brief_canvas": 1},
                           unused=("brief_level",), expected=(12, 2713))
    per_level = run_system(seq, cfg_levels, device, N_FRAMES_PER_LEVEL,
                           {"fast_score": 1, "brief_level": 1},
                           unused=("brief_canvas",), expected=(5, 859))
    pipelined = run_system(seq, cfg, device, N_FRAMES,
                           {"fast_score": 1, "brief_canvas": 1},
                           unused=("brief_level",), pipelined=True)
    ate_sync, ate_async = main_path["ate"], pipelined["ate"]
    require(ate_async < max(2.0 * ate_sync, 0.15),
            f"pipelined ATE {ate_async:.4f} m against {ate_sync:.4f} m synchronous")
    run_kidnap(seq, pipelined["system"], N_FRAMES)
    per_level_async = run_system(seq, cfg_levels, device, N_FRAMES_PER_LEVEL,
                                 {"fast_score": 1, "brief_level": 1},
                                 unused=("brief_canvas",), pipelined=True)
    log(f"frames/s on the card: Tracker {tracked['fps']:.3f}, "
        f"fused_track_chain_step {fused['fps']:.3f}, System "
        f"{main_path['fps']:.3f}, System pipelined {pipelined['fps']:.3f} "
        f"(ATE {ate_async:.4f} m against {ate_sync:.4f} m), System per level "
        f"{per_level['fps']:.3f}, pipelined {per_level_async['fps']:.3f}")

    t0 = time.perf_counter()
    full_seq, small_seq, feed_seq = (f.result() for f in renders[:3])
    log(f"loop and window_feed sequences rendered ({time.perf_counter() - t0:.1f} s "
        f"waited for)")
    full = run_loop_full_width(full_seq, device)
    tier1 = run_loop_tier1(small_seq, device)
    log(f"loops: full width closed {full['closed']}, ATE corrected "
        f"{full['ate_corr']:.4f} m; 512x160 closed {tier1['closed']}, ATE "
        f"corrected {tier1['ate_corr']:.4f} m")

    window = run_window(seq, cfg, device, N_FRAMES, fed=False,
                        ate_per_frame=ate_sync, factor=3.0, floor=0.05)
    feed_cfg = config_of(feed_seq, N_FEATURES)
    feed_per_frame = run_system(feed_seq, feed_cfg, device, N_FRAMES,
                                {"fast_score": 1, "brief_canvas": 1},
                                unused=("brief_level",))
    fed = run_window(feed_seq, feed_cfg, device, N_FRAMES, fed=True,
                     ate_per_frame=feed_per_frame["ate"], factor=7.0, floor=0.25)
    log(f"windowed schedule: track_stereo_window {window['fps']:.3f} frames/s, ATE "
        f"{window['ate']:.4f} m (per frame {ate_sync:.4f}); window_feed "
        f"{fed['fps']:.3f} frames/s, ATE {fed['ate']:.4f} m (per frame "
        f"{feed_per_frame['ate']:.4f})")
    tiled = gba_tiling.tile(main_path["system"].map, cfg, pad_to=SHARDS, **GBA_TILE)
    run_checkpoint(main_path["system"], seq)
    run_sharded(tiled, tier1["system"], device, smi)
    run_viewer(seq, cfg, device)
    run_renderer(renders[3].result(), device, smi)
    scale = run_scale(renders[4].result(), device)
    for f in renders[5]:
        f.result()
    benched = run_bench(seq, device, ate_sync)

    # launches: each kernel's count from the System run of its own path;
    # the main path is the pipelined schedule
    launches = dict(pipelined["counts"])
    launches["brief_level"] = per_level["counts"]["brief_level"]
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        rec["launches_scale"] = scale["counts"][rec["name"]]
        rec["launches_bench"] = benched["counts"][rec["name"]]
        require(rec["launches"] > 0, f"{rec['name']} never launched on its path")
    records[1]["highdensity"] = benched["dense"]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
