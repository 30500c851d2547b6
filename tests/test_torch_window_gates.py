"""The port counterparts of tests/test_system.py::TestWindowedTracking: the
windowed schedules over 28 frames of the 512x160 straight sequence, each
on the port's own frames and held to the JAX test's gate against the
port's own per-frame run.

* ``track_stereo_window`` at 0.8 m a frame: ATE under max(3 x per frame,
  0.05 m), at least 3 keyframes.
* ``window_feed`` / ``window_flush`` at 0.5 m a frame, the schedule's
  operating envelope: every frame returned once, ATE under max(7 x per
  frame, 0.25 m).

``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_window_gates.py``
prints the runs behind PERF.md's figures: both packages on the two
sequences and on three copies of each with one grey level added to 0.01%
of the pixels, with the landmark bindings that repeat inside a committed
frame and the committed rotations' distance from orthonormal.
"""

import os

import torch

from test_torch_mapping import make_cfgs

from pyorbslam_tpu.io.synthetic import generate_sequence
from pyorbslam_tpu.slam import system as jsystem

from pyorbslam_tpu_torch.slam import system as tsystem
from pyorbslam_tpu_torch.tools.window_envelope import run

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
N, W = 28, 4


def sequence(speed, cache_dir):
    return generate_sequence(n_frames=N, width=512, height=160,
                             trajectory="straight", speed=speed, seed=3,
                             cache_dir=cache_dir)


class TestWindowedTracking:
    def test_window_matches_per_frame_quality(self, data_cache_dir):
        """track_stereo_window (one dispatch per W frames, the map frozen
        within a window) lands in the per-frame accuracy class."""
        seq = sequence(0.8, data_cache_dir)
        _, tc = make_cfgs(seq)
        pf, _ = run(tsystem.System(tc, CPU), seq, "per_frame")
        sw = tsystem.System(tc, CPU)
        rec, poses = run(sw, seq, "window")
        assert len(sw.trajectory) == len(poses) == N
        assert rec["ate"] < max(3.0 * pf["ate"], 0.05), (pf["ate"], rec["ate"])
        assert sw.map.keyframes.n >= 3
        # every committed pose is rigid (ROADMAP.md queue 3, F4)
        assert rec["rotation_error"] < 1e-5, rec["rotation_error"]
        assert sw.time_counts["window.dispatch"] == N // W
        assert any(e.startswith("retrack:") for e in rec["events"])

    def test_pipelined_window_matches_per_frame_quality(self, data_cache_dir):
        """window_feed / window_flush inside the schedule's operating
        envelope."""
        seq = sequence(0.5, data_cache_dir)
        _, tc = make_cfgs(seq)
        pf, _ = run(tsystem.System(tc, CPU), seq, "per_frame")
        sf = tsystem.System(tc, CPU)
        rec, poses = run(sf, seq, "feed")
        assert len(poses) == N and len(sf.trajectory) == N
        assert sf._pending_window is None
        assert rec["ate"] < max(7.0 * pf["ate"], 0.25), (rec["ate"], pf["ate"])
        assert rec["rotation_error"] < 1e-5, rec["rotation_error"]


def envelope(cache_dir):
    """Both packages' windowed schedules on the two sequences and three
    perturbed copies of each: ATE, keyframes, repeated bindings, rotation
    error."""
    for speed, mode in ((0.8, "window"), (0.5, "feed")):
        seq = sequence(speed, cache_dir)
        jc, tc = make_cfgs(seq)
        systems = (("jax", lambda: jsystem.System(jc)),
                   ("port", lambda: tsystem.System(tc, CPU)))
        for name, make in systems:
            rec, _ = run(make(), seq, "per_frame")
            print(f"per_frame at {speed} m a frame, {name}: ATE {rec['ate']:.4f} m",
                  flush=True)
        for seed in (0, 1, 2, 3):
            for name, make in systems:
                rec, poses = run(make(), seq, mode, seed)
                print(f"{mode} at {speed} m a frame, perturbation seed {seed}, "
                      f"{name}: ATE {rec['ate']:.4f} m, {len(poses)} poses, "
                      f"{rec['keyframes']} keyframes, repeated bindings "
                      f"{rec['repeated_bindings']['mean']:.2f} a frame "
                      f"(at most {rec['repeated_bindings']['max']}), rotation "
                      f"error {rec['rotation_error']:.2e}", flush=True)


if __name__ == "__main__":
    envelope(os.path.join(os.path.dirname(os.path.abspath(__file__)), "_data"))
