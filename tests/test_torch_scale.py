"""The port at scale: tests/test_scale.py's five gates on the port's own
run, and the port's evaluation entry points
(``pyorbslam_tpu_torch/tools/eval_scale.py``, ``eval_synth.py``).

The module fixture runs the port's ``System`` on the CPU over
``test_scale.py``'s own sequence and configuration (150 frames of the
512x160 radius-14 loop, 2.2 laps, seed 11, 1000 features, the CG pose
graph forced by ``pose_graph_cg_threshold=16``, ``track_stereo``).  The
test bodies are the JAX class's, held on the port's run; the JAX run of
the same frames is ``test_scale.py``'s and is not repeated here.

The tools run at a tiny size with ``--device cpu`` (one JSON line with
their keys), and with ``--device cuda`` on a machine without CUDA, where
they must raise instead of running on the CPU.
"""

import dataclasses
import json

import pytest
import torch

from test_scale import TestScaleRun as JaxScaleRun

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.tools import eval_scale, eval_synth

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scale_run(data_cache_dir):
    """``tests/test_scale.py::scale_run`` on the port."""
    n = 150
    seq = generate_sequence(
        n_frames=n, width=512, height=160, trajectory="loop",
        seed=11, laps=2.2, loop_radius=14.0, cache_dir=data_cache_dir)
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=1000),
    )
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, pose_graph_cg_threshold=16))
    sysm = System(cfg, CPU)
    for i in range(n):
        sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
    sysm.shutdown()
    return sysm, seq, n


class TestScaleRun(JaxScaleRun):
    """``tests/test_scale.py::TestScaleRun``'s bodies on the port's run:
    every frame tracked, the loop machinery engaged over the laps, ATE
    under 0.5% of the path, finite numerics, export through culled
    keyframes."""


def last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


class TestEvalTools:
    SCALE_ARGS = ["--device", "cpu", "--frames", "16", "--width", "320",
                  "--height", "120", "--features", "500", "--radius", "14",
                  "--laps", "0.2", "--scene", "interior"]

    @pytest.mark.parametrize("window", [0, 4])
    def test_eval_scale_cpu(self, capsys, window):
        """Pipelined (``--window 0``) and windowed (``--window 4``) runs
        print one JSON line with the JAX tool's keys and the port's own."""
        eval_scale.main(self.SCALE_ARGS + ["--window", str(window)])
        rec = last_json(capsys.readouterr().out)
        for key in ("metric", "frames", "fps", "ate_rmse_m", "track_len_m",
                    "keyframes_alive", "keyframes_total", "landmarks",
                    "loops_closed", "loops_rejected", "loops_fused",
                    "ba_rejected_writebacks", "render_s", "slam_s", "scene",
                    "loop_closing", "render_backend", "backend", "device",
                    "peak_device_mb", "frames_per_s_first_100",
                    "frames_per_s_last_100"):
            assert key in rec, key
        assert rec["metric"] == "scale_run" and rec["frames"] == 16
        assert rec["backend"] == "cpu" and rec["device"] == "cpu"
        assert rec["keyframes_alive"] >= 1 and rec["landmarks"] > 0
        assert rec["ate_rmse_m"] < 0.05 * rec["track_len_m"]

    def test_eval_synth_cpu(self, capsys, data_cache_dir):
        eval_synth.main(["--device", "cpu", "--quick", "--frames", "8",
                         "--cache-dir", data_cache_dir])
        rec = last_json(capsys.readouterr().out)
        assert rec["metric"] == "synthetic_batch_eval"
        assert [r["seq"] for r in rec["sequences"]] == ["straight-0", "straight-1"]
        for r in rec["sequences"]:
            assert r["frames"] == 8 and r["ate_rmse_m"] < 0.1
            for key in ("path_m", "rpe_t_m", "rpe_r_deg", "kfs", "loops", "fps"):
                assert key in r
        assert rec["device"] == "cpu"

    @pytest.mark.parametrize("tool", [eval_scale, eval_synth])
    def test_no_cuda_raises(self, tool, monkeypatch):
        """The default ``--device cuda`` fails where CUDA is missing: no
        fall-back to the CPU."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            tool.main(["--frames", "4"])
