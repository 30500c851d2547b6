"""The negative loop-closure gate on the port: tests/test_loop_negative.py's
aliased world (a 256-px texture tiled every 4 m, 0.85 laps of a radius-18
loop, so no place is ever revisited) rendered by the port's
``io/synthetic.py`` and tracked by the port's ``System`` on the CPU.  The
test bodies are the JAX class's: no loop accepted, and the corrected
trajectory within 5% of the path.
"""

import numpy as np
import pytest
import torch

from test_loop_negative import TestNegativeLoopClosure as JaxNegative

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io import synthetic as syn
from pyorbslam_tpu_torch.slam.system import System

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def aliased_loop_run():
    """``tests/test_loop_negative.py::aliased_loop_run`` on the port."""
    n, width, height = 64, 512, 160
    radius = 18.0
    poses = syn.loop_trajectory(n, radius=radius, laps=0.85)
    tex = syn.make_texture(256, seed=11)
    planes = syn.corridor_scene(width_m=2 * radius + 12.0, tex_px_per_m=64.0)
    fx = 0.58 * width
    K = np.array([[fx, 0, width / 2.0], [0, fx, height / 2.0 - 10.0],
                  [0, 0, 1]])
    baseline = 0.54
    off = np.array([baseline, 0.0, 0.0])
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=fx, fy=fx, cx=width / 2.0, cy=height / 2.0 - 10.0,
            width=width, height=height, bf=fx * baseline, th_depth=40.0),
        orb=OrbConfig(n_features=1000),
    )
    sysm = System(cfg, CPU)
    for i in range(n):
        Twc = poses[i]
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ off
        left = syn._to_u8(syn.render_view(Twc, K, width, height, planes, tex))
        right = syn._to_u8(syn.render_view(Twc_r, K, width, height, planes, tex))
        sysm.track_stereo(left, right, 0.1 * i)
    sysm.shutdown()
    return sysm, poses, n


class TestNegativeLoopClosure(JaxNegative):
    """``tests/test_loop_negative.py::TestNegativeLoopClosure``'s bodies on
    the port's run."""
