"""The PyTorch port's live viewer (``viz/live_viewer.py``) and offline
drawer (``viz/drawer.py``) against the JAX package's.

A JAX ``System`` tracks the first 8 frames of the cached straight
sequence (``tests/test_viewer.py``'s run) and is carried into a port
``System`` by ``convert.system_from_numpy``.  The port viewer's state of
the carried system equals the JAX viewer's of the source: every count and
list length equal, coordinates within 0.011 (one step of the 2-decimal
rounding both round to).  The drawer's PNGs of the carried map equal the
JAX package's pixel for pixel.  The HTTP surface is checked on a port
``System``'s own run with ``tests/test_viewer.py``'s assertions.
"""

import base64
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from test_torch_mapping import make_cfgs

from pyorbslam_tpu.io.synthetic import generate_sequence
from pyorbslam_tpu.slam import system as jsystem
from pyorbslam_tpu.viz import drawer as jdrawer
from pyorbslam_tpu.viz import live_viewer as jviewer

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.slam.system import System
from pyorbslam_tpu_torch.viz import drawer as tdrawer
from pyorbslam_tpu_torch.viz import live_viewer as tviewer

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
N_FRAMES = 8
COORD_TOL = 0.011


@pytest.fixture(scope="module")
def seq(data_cache_dir):
    return generate_sequence(
        n_frames=N_FRAMES, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir)


@pytest.fixture(scope="module")
def carried(seq):
    """The JAX System after 8 frames (native index recounted) and the
    port's copy of it, the viewer image and last frame snapshot set on
    both as their trackers leave them."""
    jc, tc = make_cfgs(seq, n_features=600)
    jsys = jsystem.System(jc)
    for i in range(N_FRAMES):
        jsys._viewer_image = seq.left[i]
        jsys.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
    jsys.map.rebuild_core()
    port = convert.system_from_numpy(jsys, tc, CPU)
    port._viewer_image = jsys._viewer_image
    # the last frame's host snapshot, which the trackers pull themselves at
    # a keyframe: the viewer's keypoints
    for sysm in (jsys, port):
        sysm._frame_host(sysm.last_frame)
    return jsys, port


def assert_coords_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.size:
        assert np.abs(got - want).max() <= COORD_TOL, what


def test_state_equals_jax(carried):
    jsys, port = carried
    want = jviewer.LiveViewer(jsys).state()
    got = tviewer.LiveViewer(port).state()
    assert sorted(got) == sorted(want)
    assert got["status"] == want["status"]
    assert got["covis"] == want["covis"]
    for key in ("points", "kf_xy", "traj", "cam", "keypoints"):
        assert_coords_close(got[key], want[key], key)
    assert len(got["keypoints"]) > 0
    assert (got["frame_w"], got["frame_h"]) == (want["frame_w"], want["frame_h"])
    assert got["frame"] == want["frame"]


def test_viewer_serves_state(seq):
    """``tests/test_viewer.py::test_viewer_serves_state`` on the port's own
    ``System`` run."""
    _, tc = make_cfgs(seq, n_features=600)
    sysm = System(tc, CPU)
    for i in range(N_FRAMES):
        sysm._viewer_image = seq.left[i]
        sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])

    viewer = tviewer.LiveViewer(sysm, port=0).start()
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        page = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"follow camera" in page
        state = json.loads(
            urllib.request.urlopen(f"{base}/state", timeout=10).read())
        assert state["status"]["kfs"] >= 1
        assert state["status"]["lms"] > 100
        assert len(state["points"]) == state["status"]["lms"] or \
            len(state["points"]) > 0
        assert len(state["traj"]) == N_FRAMES
        assert state["cam"] is not None
        # the camera advanced ~0.8 m/frame along +z
        assert state["traj"][-1][1] > 3.0
        assert state["frame"], "frame image missing"
    finally:
        viewer.stop()


def test_bmp_encoder_roundtrip_header():
    img = (np.arange(40 * 64, dtype=np.uint8).reshape(40, 64) % 251)
    raw = base64.b64decode(tviewer._gray_bmp_b64(img, stride=1))
    assert raw[:2] == b"BM"
    w = int.from_bytes(raw[18:22], "little")
    h = int.from_bytes(raw[22:26], "little")
    assert (w, h) == (64, 40)
    assert raw == base64.b64decode(jviewer._gray_bmp_b64(img, stride=1))


def test_drawer_pngs_equal_jax(carried, tmp_path):
    import matplotlib.image as mpimg

    jsys, port = carried
    snap = port._frame_cache[1]
    va = snap["valid"]
    tracked = np.zeros(int(va.sum()), bool)
    tracked[::3] = True
    traj = np.linalg.inv(np.stack(port.trajectory).astype(np.float64))
    paths = {}
    for name, mod, sysm in (("jax", jdrawer, jsys), ("port", tdrawer, port)):
        paths[name] = (str(tmp_path / f"{name}_frame.png"),
                       str(tmp_path / f"{name}_map.png"))
        mod.draw_frame(sysm._viewer_image, snap["xy"][va], tracked, sysm.state,
                       sysm.map.keyframes.n, int(sysm.map.landmarks.alive.sum()),
                       paths[name][0])
        mod.draw_map(sysm.map, traj, paths[name][1])
    for got, want in zip(paths["port"], paths["jax"]):
        a, b = mpimg.imread(got), mpimg.imread(want)
        assert a.shape == b.shape and a.size > 0
        np.testing.assert_array_equal(a, b)
        assert os.path.getsize(got) > 1000
