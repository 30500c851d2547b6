"""Map checkpoints of the PyTorch port (``utils/checkpoint.py``): the port
counterpart of tests/test_checkpoint.py (round trip, a fresh covisibility
recount, tracking resumed on the loaded map), and files crossing between
the packages: a JAX ``save_map`` file loaded by the port's ``load_map``
equals ``convert``'s copy of the same map, and a port file loaded by the
JAX ``load_map`` equals the port's map.  Everything is compared exactly:
a checkpoint copies arrays, and descriptors keep their bits (uint32 in
the file and the JAX package, int32 in the port).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from test_torch_mapping import make_cfgs

from pyorbslam_tpu.io.synthetic import generate_sequence
from pyorbslam_tpu.slam import system as jsystem
from pyorbslam_tpu.utils import checkpoint as jckpt

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.slam import system as tsystem
from pyorbslam_tpu_torch.utils import checkpoint as tckpt

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
LANDMARK_FIELDS = ("pos", "normal", "dmin", "dmax", "visible", "found",
                   "alive", "replaced_by")


@pytest.fixture(scope="module")
def seq20(data_cache_dir):
    return generate_sequence(
        n_frames=20, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir)


@pytest.fixture(scope="module")
def port_run(seq20, tmp_path_factory):
    """tests/test_checkpoint.py's run on the port: the default System
    over 12 frames, its map saved."""
    _, tc = make_cfgs(seq20)
    s = tsystem.System(tc, CPU)
    for i in range(12):
        s.track_stereo(seq20.left[i], seq20.right[i], seq20.timestamps[i])
    path = str(tmp_path_factory.mktemp("ckpt") / "port_map.npz")
    tckpt.save_map(s.map, path)
    return dict(system=s, map=s.map, path=path, tc=tc)


@pytest.fixture(scope="module")
def jax_run(seq20, tmp_path_factory):
    """The JAX package's run over the same 12 frames, its map saved.  A
    12-frame straight run closes no loop and culls no keyframe, so a loop
    edge and a culled keyframe's anchor are written into the map before
    it is saved: the file then carries every kind of entry it has."""
    jc, tc = make_cfgs(seq20)
    s = jsystem.System(jc)
    for i in range(12):
        s.track_stereo(seq20.left[i], seq20.right[i], seq20.timestamps[i])
    m = s.map
    assert m.keyframes.n >= 3
    m.loop_edges.setdefault(m.keyframes.n - 1, set()).add(0)
    m.loop_edges.setdefault(0, set()).add(m.keyframes.n - 1)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = (0.25, -0.5, 1.0)
    m.dead_anchor[1] = (0, T)
    path = str(tmp_path_factory.mktemp("ckpt") / "jax_map.npz")
    jckpt.save_map(m, path)
    return dict(system=s, path=path, jc=jc, tc=tc)


def assert_maps_equal(a, b):
    """Two maps (either package) hold the same keyframes, landmarks,
    descriptor bits, spanning tree, loop edges and culled-keyframe
    anchors."""
    la, lb, ka, kb = a.landmarks, b.landmarks, a.keyframes, b.keyframes
    assert la.n == lb.n and ka.n == kb.n
    nl, nk = la.n, ka.n
    for f in LANDMARK_FIELDS:
        np.testing.assert_array_equal(getattr(la, f)[:nl], getattr(lb, f)[:nl], err_msg=f)
    np.testing.assert_array_equal(convert.desc_from_port(la.desc[:nl]),
                                  convert.desc_from_port(lb.desc[:nl]))
    for f in convert.KEYFRAME_FIELDS:
        np.testing.assert_array_equal(getattr(ka, f)[:nk], getattr(kb, f)[:nk], err_msg=f)
    np.testing.assert_array_equal(convert.desc_from_port(ka.kp_desc[:nk]),
                                  convert.desc_from_port(kb.kp_desc[:nk]))
    assert a.parent == b.parent and a.children == b.children
    assert a.loop_edges == b.loop_edges
    assert sorted(a.dead_anchor) == sorted(b.dead_anchor)
    for k, (p, T) in a.dead_anchor.items():
        assert b.dead_anchor[k][0] == p
        np.testing.assert_array_equal(b.dead_anchor[k][1], T)


def covis(m) -> dict:
    ca, cb, cw = m.core.covis_edges()
    return {(int(x), int(y)): int(w) for x, y, w in zip(ca, cb, cw)}


class TestRoundTrip:
    """tests/test_checkpoint.py on the port."""

    def test_round_trip(self, port_run):
        m = port_run["map"]
        m2 = tckpt.load_map(port_run["tc"], CPU, port_run["path"])
        assert m2.device == CPU and m2.keyframes.n == m.keyframes.n >= 2
        assert m2.landmarks.n == m.landmarks.n
        assert_maps_equal(m2, m)
        np.testing.assert_array_equal(
            m2.keyframes.obs_lm[: m2.keyframes.n], m.keyframes.obs_lm[: m.keyframes.n])

    def test_covisibility_is_a_fresh_recount(self, port_run):
        """The loaded covisibility is the recount of the restored
        observation table (a live map's weights are kept incrementally)."""
        m2 = tckpt.load_map(port_run["tc"], CPU, port_run["path"])
        obs = m2.keyframes.obs_lm[: m2.keyframes.n]
        got = covis(m2)
        assert got
        for (a, b), w in got.items():
            ca = Counter(obs[a][obs[a] >= 0].tolist())
            cb = Counter(obs[b][obs[b] >= 0].tolist())
            assert w == sum(ca[k] * cb[k] for k in ca.keys() & cb.keys()), (a, b)

    def test_resume_on_the_loaded_map(self, port_run, seq20):
        """Swap the loaded map into the System and track 8 more frames:
        tracking holds and mapping goes on in the loaded map."""
        s = port_run["system"]
        m2 = tckpt.load_map(port_run["tc"], CPU, port_run["path"])
        s.map = m2
        if s.local_mapper is not None:
            s.local_mapper.map = m2
        if s.loop_closer is not None:
            s.loop_closer.map = m2
        for i in range(12, 20):
            s.track_stereo(seq20.left[i], seq20.right[i], seq20.timestamps[i])
        assert s.state in ("OK", "MARGINAL")
        assert s.stats[-1]["inliers"] > 30
        assert m2.keyframes.n > port_run["map"].keyframes.n


class TestAcrossPackages:
    def test_jax_file_loads_in_the_port(self, jax_run):
        js = jax_run["system"]
        got = tckpt.load_map(jax_run["tc"], CPU, jax_run["path"])
        want = convert.system_from_numpy(js, jax_run["tc"], CPU).map
        assert got.loop_edges and got.dead_anchor          # the entries crossed
        assert_maps_equal(got, want)
        n = got.landmarks.n
        np.testing.assert_array_equal(got.landmarks.n_obs[:n], want.landmarks.n_obs[:n])
        assert covis(got) == covis(want)

    def test_port_file_loads_in_the_jax_package(self, port_run, jax_run):
        got = jckpt.load_map(jax_run["jc"], port_run["path"])
        assert_maps_equal(got, port_run["map"])
        # both packages rebuild the same index from the same table
        back = tckpt.load_map(port_run["tc"], CPU, port_run["path"])
        n = got.landmarks.n
        np.testing.assert_array_equal(got.landmarks.n_obs[:n], back.landmarks.n_obs[:n])
        assert covis(got) == covis(back)

    def test_files_have_the_same_keys_and_types(self, port_run, jax_run):
        """The port writes the JAX package's keys with its dtypes."""
        a, b = np.load(port_run["path"]), np.load(jax_run["path"])
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
        assert a["kf_desc"].dtype == np.uint32 and a["lm_desc"].dtype == np.uint32
