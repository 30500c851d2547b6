"""The PyTorch port's windowed schedule against the JAX package:
``fused_track_window``, the re-track program (its row alone and with the
insertion snapshot after it), and one carried window in each of the two
windowed schedules (``track_stereo_window``, ``window_feed`` /
``window_flush``).

One JAX ``System`` runs the first 12 frames of the cached 512x160
sequence (loop closing off) and is carried into the port with
``convert.system_from_numpy``.  Tolerances:

* device programs on the same inputs: the chain step's
  (tests/test_torch_tracking.py): stats within one match, assignments equal
  on >= 99% of slots, poses within the pose optimizer's own tolerance
  (rotation 1e-4 rad, translation 1e-3 m).  Rows past the first of a scan
  chain on each package's own frames, whose descriptors differ in ~0.03%
  of their bits (ROADMAP.md queue 3, IC angle rounding);
* the snapshot half of the re-track (pack_frame, BoW words, weight bits,
  nodes) is a gather and a tree descent on identical features: equal;
* carried schedules: the same keyframes and the same ``retrack:*``
  events; ``track_stereo_window``'s 4 poses and the first 4 of
  ``window_feed`` within 1 cm and 1e-3 rad.  In the fourth row of the
  first scan one stereo inlier at the chi2 edge flips (198 against 199;
  ROADMAP.md queue 3, float comparisons): that pose moves by 5 mm, and
  the feed's second scan, which chains from it on a map that lags up to
  2W - 1 frames, starts 3.3 cm and 1.38e-3 rad from the JAX package's
  (the CPU), where the JAX package's own poses lie 7-15 cm from the truth.
  The test asserts the flip (every stats count of the first window within
  one) and holds the second window's 4 poses to 5 cm and 2e-3 rad.

The port counterparts of tests/test_system.py::TestWindowedTracking (the
accuracy gates over 28 frames) are in tests/test_torch_window_gates.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mapping import make_cfgs

from pyorbslam_tpu.io.synthetic import generate_sequence
from pyorbslam_tpu.slam import frame as jframe
from pyorbslam_tpu.slam import system as jsystem
from pyorbslam_tpu.slam import tracking as jtrack

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.slam import tracking as ttrack

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
ROT_TOL, TRANS_TOL = 1e-4, 1e-3          # tests/test_torch_tracking.py's
POSE_M, POSE_RAD = 0.01, 1e-3            # carried track_stereo_window
FEED_M, FEED_RAD = 0.05, 2e-3            # window_feed after the flip (docstring)
N_CARRY = 12


def T(a):
    return torch.as_tensor(np.array(a, order="C"))


def rot_angle(Ta, Tb) -> float:
    """||Ra - Rb||_F / sqrt(2): the angle between them for small angles."""
    Ta, Tb = np.asarray(Ta, np.float64), np.asarray(Tb, np.float64)
    return float(np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / np.sqrt(2.0))


def assert_row_close(trow, jrow, n, p_words, what):
    """One packed row of each package: [stats 5 | Tcw 16 | assign n |
    p_visible], the visibility as ``p_words`` bit words (None: 0/1)."""
    assert trow.shape == jrow.shape, what
    assert np.abs(trow[:5] - jrow[:5]).max() <= 1, (what, trow[:5], jrow[:5])
    Tt = trow[5:21].view(np.float32).reshape(4, 4)
    Tj = jrow[5:21].view(np.float32).reshape(4, 4)
    assert rot_angle(Tt, Tj) < ROT_TOL, (what, rot_angle(Tt, Tj))
    assert np.abs(Tt[:3, 3] - Tj[:3, 3]).max() < TRANS_TOL, (what, Tt[:3, 3] - Tj[:3, 3])
    assert (trow[21:21 + n] == jrow[21:21 + n]).mean() >= 0.99, what
    if p_words is None:
        vt, vj = trow[21 + n:], jrow[21 + n:]
    else:
        vt = ttrack.unpack_bool_np(trow[21 + n:], p_words * 32)
        vj = jtrack.unpack_bool_np(jrow[21 + n:], p_words * 32)
    assert (vt == vj).mean() >= 0.99, what


@pytest.fixture(scope="module")
def seq30(data_cache_dir):
    return generate_sequence(
        n_frames=30, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir)


def jax_system(jc):
    return jsystem.System(jc, landmark_capacity=1 << 16, keyframe_capacity=128,
                          enable_loop_closing=False)


@pytest.fixture(scope="module")
def carried(seq30):
    """The JAX System after 12 frames, the inputs of a window starting at
    frame 12 as the JAX ``_dispatch_window`` forms them, and the port's
    copy of that state."""
    jc, tc = make_cfgs(seq30)
    jsys = jax_system(jc)
    for i in range(N_CARRY):
        jsys.track_stereo(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    assert jsys.state == "OK" and jsys.map.keyframes.n >= 3
    store = jsys.map.landmarks
    local = jsys._spatial_point_ids(jsys.Tcw)
    cap = jsystem._cap_bucket(len(local), jc.tracking.max_local_points)
    p_ids = np.full(cap, -1, np.int32)
    p_ids[: len(local)] = local
    inputs = dict(
        p_ids=p_ids, q_lm=store.resolve(jsys.last_assign),
        Tlw=np.array(jsys.Tcw, np.float32),
        Tllw=(np.linalg.inv(jsys.velocity) @ jsys.Tcw).astype(np.float32),
        Tcw_pred=(jsys.velocity @ jsys.Tcw).astype(np.float32),
        mirror_j=[jnp.asarray(getattr(store, k)) for k in convert.MIRROR_FIELDS],
        mirror_t=[convert.landmark_mirror(convert.landmarks_from_numpy(store), CPU)[k]
                  for k in convert.MIRROR_FIELDS],
        frame_j=jsys.last_frame,
        frame_t=convert.frame_from_numpy(jsys.last_frame, CPU))
    return dict(jsys=jsys, jc=jc, tc=tc, inputs=inputs,
                port=convert.system_from_numpy(jsys, tc, CPU))


@pytest.fixture(scope="module")
def window_rows(carried, seq30):
    """fused_track_window over frames 12-14 in both packages."""
    x, jc, tc = carried["inputs"], carried["jc"], carried["tc"]
    images = np.stack([np.stack([seq30.left[i], seq30.right[i]])
                       for i in range(N_CARRY, N_CARRY + 3)])
    jrows, jframes, jcarry = jtrack.fused_track_window(
        jnp.asarray(images), *x["mirror_j"], x["frame_j"], jnp.asarray(x["q_lm"]),
        jnp.asarray(x["p_ids"]), jnp.asarray(x["Tlw"]), jnp.asarray(x["Tllw"]), jc)
    trows, tframes, tcarry = ttrack.fused_track_window(
        T(images), *x["mirror_t"], x["frame_t"], T(x["q_lm"]), T(x["p_ids"]),
        T(x["Tlw"]), T(x["Tllw"]), tc)
    return dict(j=np.asarray(jrows), t=trows.numpy(), tframes=tframes,
                tcarry=tcarry, jframes=jframes, images=images)


class TestDevicePrograms:
    @pytest.mark.parametrize("row", [0, 1, 2])
    def test_fused_track_window_rows(self, window_rows, carried, row):
        """Each of the W = 3 rows against the JAX scan's, at the chain
        step's tolerance."""
        n = carried["port"].last_frame.capacity
        p_words = len(carried["inputs"]["p_ids"]) // 32
        j, t = window_rows["j"], window_rows["t"]
        assert t.shape == j.shape == (3, 21 + n + p_words)
        assert j[row, 0] > 100
        assert_row_close(t[row], j[row], n, p_words, f"row {row}")

    def test_window_carry_and_frames(self, window_rows, carried, seq30):
        """The final carry is (last frame, its assignment, its pose, the
        pose before it), all on the device; each scanned frame is the
        frame the chain step builds from the same images."""
        t = window_rows["t"]
        n = carried["port"].last_frame.capacity
        frame, assign, Tcw, Tlw = window_rows["tcarry"]
        assert frame is window_rows["tframes"][-1] and len(window_rows["tframes"]) == 3
        np.testing.assert_array_equal(assign.numpy(), t[-1, 21:21 + n])
        np.testing.assert_array_equal(Tcw.numpy(), t[-1, 5:21].view(np.float32).reshape(4, 4))
        np.testing.assert_array_equal(Tlw.numpy(), t[-2, 5:21].view(np.float32).reshape(4, 4))
        x, tc = carried["inputs"], carried["tc"]
        row0, frame0 = ttrack.fused_track_chain_step(
            T(seq30.left[N_CARRY]), T(seq30.right[N_CARRY]), *x["mirror_t"],
            x["frame_t"], T(x["q_lm"]), T(x["Tcw_pred"]), T(x["Tlw"]),
            T(x["p_ids"]), tc)
        for a, b in zip(frame0, window_rows["tframes"][0]):
            assert torch.equal(a, b)
        assert_row_close(row0.numpy(), t[0], n, len(x["p_ids"]) // 32, "chain step")

    @pytest.mark.parametrize("th_base", [7.0, 28.0])
    def test_fused_retrack_step(self, carried, window_rows, th_base):
        """The re-track of frame 12 (built by the JAX package, carried over)
        against the map as of frame 11: the port's row, its bit-packed
        visibility unpacked, against the JAX package's unpacked row."""
        x, jc, tc = carried["inputs"], carried["jc"], carried["tc"]
        left, right = window_rows["images"][0]
        fj = jframe.build_stereo_frame_jit(jnp.asarray(left), jnp.asarray(right), jc)
        ft = convert.frame_from_numpy(fj, CPU)
        args_j = (*x["mirror_j"], jnp.asarray(x["q_lm"]), x["frame_j"],
                  jnp.asarray(x["p_ids"]), jnp.asarray(x["Tcw_pred"]), jnp.asarray(x["Tlw"]))
        args_t = (*x["mirror_t"], T(x["q_lm"]), x["frame_t"], T(x["p_ids"]),
                  T(x["Tcw_pred"]), T(x["Tlw"]))
        jrow = np.asarray(jtrack.fused_retrack_step(fj, *args_j, jc, th_base=th_base))
        trow_t, _, _ = ttrack.fused_retrack_step(ft, *args_t, tc, th_base=th_base)
        trow = trow_t.numpy()
        n, P = ft.capacity, len(x["p_ids"])
        assert jrow.shape == (21 + n + P,) and trow.shape == (21 + n + P // 32,)
        unpacked = np.concatenate([
            trow[:21 + n], ttrack.unpack_bool_np(trow[21 + n:], P).astype(np.int32)])
        assert_row_close(unpacked, jrow, n, None, f"retrack th={th_base}")

        # the re-track of a keyframe-to-be: the row, then the insertion
        # snapshot, in one read
        jsys = carried["jsys"]
        jvoc, tvoc = jsys.vocabulary, carried["port"].vocabulary
        jsnap = np.asarray(jtrack.fused_retrack_snapshot_step(
            fj, *args_j, jc, jvoc._device_arrays(), jvoc.k, jvoc.L,
            jvoc.feature_levels_up, th_base=th_base))
        tsnap = torch.cat([trow_t, ttrack.kf_snapshot(
            ft, tvoc._device_arrays(CPU), tvoc.k, tvoc.L,
            tvoc.feature_levels_up)]).numpy()
        assert jsnap.shape == (21 + n + P + 19 * n,)
        assert tsnap.shape == (len(trow) + 19 * n,)
        np.testing.assert_array_equal(tsnap[len(trow):], jsnap[21 + n + P:])


# ------------------------------------------------- carried schedules


def string_events(system, prefix):
    return [e for e in system.events if isinstance(e, str) and e.startswith(prefix)]


def assert_poses_close(tp, jp, what, tol_m=POSE_M, tol_rad=POSE_RAD):
    assert tp.shape == jp.shape, what
    for k, (a, b) in enumerate(zip(tp, jp)):
        assert np.abs(a[:3, 3] - b[:3, 3]).max() < tol_m, (what, k, a[:3, 3] - b[:3, 3])
        assert rot_angle(a, b) < tol_rad, (what, k, rot_angle(a, b))


@pytest.fixture(scope="module")
def schedules(carried, seq30, window_rows):
    """From the carried state at frame 12, in both packages: one
    track_stereo_window over frames 12-15; and, from a second copy of that
    state, window_feed over 12-15 and 16-19, then window_flush."""
    jsys, port, jc, tc = carried["jsys"], carried["port"], carried["jc"], carried["tc"]
    jsys2 = jax_system(jc)
    for i in range(N_CARRY):
        jsys2.track_stereo(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    port2 = convert.system_from_numpy(jsys2, tc, CPU)
    out = dict(kfs0=(jsys.map.keyframes.n, port.map.keyframes.n))
    s = slice(N_CARRY, N_CARRY + 4)
    out["window"] = [
        (np.asarray(x.track_stereo_window(seq30.left[s], seq30.right[s],
                                          seq30.timestamps[s])), x)
        for x in (jsys, port)]
    fed = {}
    for name, x in (("jax", jsys2), ("port", port2)):
        poses = []
        for w0 in (N_CARRY, N_CARRY + 4):
            s = slice(w0, w0 + 4)
            poses.append(np.asarray(x.window_feed(seq30.left[s], seq30.right[s],
                                                  seq30.timestamps[s])))
        poses.append(np.asarray(x.window_flush()))
        fed[name] = (poses, x)
    out["feed"] = fed
    return out


class TestCarriedSchedules:
    def test_track_stereo_window(self, schedules):
        """One 4-frame window from the carried state: poses within 1 cm
        and 1e-3 rad, the same keyframes inserted, the same re-tracks."""
        (jp, jsys), (tp, port) = schedules["window"]
        assert tp.shape == (4, 4, 4)
        assert_poses_close(tp, jp, "track_stereo_window")
        assert schedules["kfs0"][0] == schedules["kfs0"][1]
        assert jsys.map.keyframes.n == port.map.keyframes.n
        assert string_events(port, "retrack:") == string_events(jsys, "retrack:")
        assert len(port.trajectory) == len(jsys.trajectory) == N_CARRY + 4
        assert port.time_counts["window.dispatch"] == 1
        assert port.time_counts["window.commit_total"] == 1
        assert port._mapper_queue is None and port._pending_window is None

    def test_window_feed_and_flush(self, schedules):
        """Two feeds and a flush from the carried state: the first feed
        returns nothing (its window is in flight), the second the first
        window's 4 poses, the flush the second's.  The first window's within
        1 cm and 1e-3 rad and its stats within one count; the second's
        within 5 cm and 2e-3 rad (module docstring); the same keyframes and
        re-tracks."""
        (jposes, jsys), (tposes, port) = schedules["feed"]["jax"], schedules["feed"]["port"]
        for poses in (jposes, tposes):
            assert [len(p) for p in poses] == [0, 4, 4]
        assert_poses_close(tposes[1], jposes[1], "window_feed, first window")
        for st, sj in zip(port.stats[-8:-4], jsys.stats[-8:-4]):
            for key in ("matches", "inliers", "tracked_points"):
                assert abs(st[key] - sj[key]) <= 1, (key, st, sj)
        assert_poses_close(tposes[2], jposes[2], "window_feed, second window",
                           FEED_M, FEED_RAD)
        assert jsys.map.keyframes.n == port.map.keyframes.n
        assert string_events(port, "retrack:") == string_events(jsys, "retrack:")
        assert len(port.trajectory) == N_CARRY + 8 and port._pending_window is None
        np.testing.assert_array_equal(np.stack(port.trajectory[-8:]),
                                      np.concatenate(tposes))
