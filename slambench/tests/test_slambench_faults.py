"""The correctness check against faults and the control.

A run at a small size on the CPU (512x160, 1000 features, 16-frame
sessions), past the harness's look for a card, with the timed path
broken underneath: each fault has to turn ``correct`` false against the
cell's own limits, and has to move one compared number far above what a
sound run at the same size reads.  The control (``control.broken``: the
program handed the stereo rig's ``Camera.bf`` 5% short) runs the same way
here, and at the cell's own size on the card (marked ``cuda``)."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path[:0] = [p for p in (BENCH_DIR, ROOT) if p not in sys.path]

import control  # noqa: E402
import harness  # noqa: E402
import run  # noqa: E402

torch.set_num_threads(2)

CELL = "kitti00-02.live.cruise"
SEED = 3_000_000_017
FX = 0.58 * 512
SMALL = dict(overrides=dict(camera=dict(width=512, height=160, fx=FX, fy=FX, cx=256.0,
                                        cy=70.0, bf=FX * 0.54),
                            orb=dict(n_features=1000)),
             session_frames=16, tex_size=1024)


def small_run(**kwargs):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.resolve_cell(bench, CELL)
    cell.entry = dict(cell.entry, warm_frames=6)
    line, _ = run.measure(bench, cell, SEED, 1e-3, False, torch.device("cpu"),
                          **SMALL, **kwargs)
    return line


def values(line):
    return {k: v["value"] for k, v in line["checks"].items()}


@pytest.fixture(scope="module")
def sound():
    return values(small_run())


def frozen_pose(system):
    """A tracking step that returns its state unchanged: every committed
    frame keeps the pose the system had before it."""
    inner = system._commit_chain_inner

    def commit(rec):
        before = system.Tcw.copy()
        inner(rec)
        system.Tcw = before
        system.trajectory[-1] = before.copy()

    system._commit_chain_inner = commit


def altered_descriptors(monkeypatch):
    """An answer altered where it is produced: every frame's descriptors
    come out of the frontend with two of its eight words flipped
    (consistently, so tracking still matches frame to frame)."""
    from pyorbslam_tpu_torch.slam import system as system_mod, tracking
    real = tracking.build_stereo_frame

    def build(left, right, cfg):
        frame = real(left, right, cfg)
        desc = frame.desc.clone()
        desc[:, 3:5] = ~desc[:, 3:5]
        return frame._replace(desc=desc, desc_bits=frame.desc_bits)

    monkeypatch.setattr(tracking, "build_stereo_frame", build)
    monkeypatch.setattr(system_mod, "build_stereo_frame", build)


def test_sound_run_reads_low(sound):
    assert sound["frontend_bad_pct"] < 5.0
    assert sound["pose_ate_pct"] < 1.0 and sound["kf_ate_pct"] < 1.0
    assert sound["lm_gap_m"] < 0.2


def test_unchanged_state_fails(sound):
    line = small_run(on_system=frozen_pose)
    assert line["correct"] is False
    got = values(line)
    assert got["pose_ate_pct"] > 10 * sound["pose_ate_pct"]


def test_altered_answer_fails(sound, monkeypatch):
    altered_descriptors(monkeypatch)
    line = small_run()
    assert line["correct"] is False
    assert values(line)["frontend_bad_pct"] > 10 * sound["frontend_bad_pct"]


def test_control_fails(sound):
    line = small_run(program_cfg=control.broken)
    assert line["correct"] is False
    got = values(line)
    assert max(got[k] / sound[k] for k in got) >= 3.0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_control_fails_on_card(seed):
    """The control at the cell's own size, one session, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode here")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = harness.resolve_cell(bench, CELL)
    line, _ = run.measure(bench, cell, seed, 1e-3, False, torch.device("cuda", 0),
                          program_cfg=control.broken)
    assert line["correct"] is False
    assert np.isfinite(list(values(line).values())).all()
