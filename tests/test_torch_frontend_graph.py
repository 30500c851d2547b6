"""The frontend replayed as one CUDA graph (``slam/frame.py``).

On the CPU: what a captured graph is keyed on, that CPU tensors take the
eager body, and that the ``track.frontend`` span says so.  On the card
(marked ``cuda``, skipped without one): replays bit-equal to the eager
body at both KITTI image sizes, frames kept across later replays left as
they were, one graph per image shape, uint8 images and views of a
stacked window upload, and the kernels' launch counters.

The file imports no JAX, so the card tests run on the card with
``python -m pytest --noconftest -o addopts= -m cuda
tests/test_torch_frontend_graph.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig, TrackingConfig
from pyorbslam_tpu_torch.io.synthetic import make_texture
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.slam import frame as frame_mod
from pyorbslam_tpu_torch.tools import profile_system
from pyorbslam_tpu_torch.utils import trace

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend.
torch.set_num_threads(2)

# KITTI 00-02 and 04-12 image sizes (width, height)
SIZES = [(1241, 376), (1226, 370)]


def small_cfg(**orb) -> SlamConfig:
    return SlamConfig(camera=CameraConfig(width=192, height=96),
                      orb=OrbConfig(n_features=300, n_levels=3, **orb))


def stereo_pair(width: int, height: int, k: int, tex: np.ndarray):
    """Frame ``k``: a crop of the texture at its own offset, the right
    image the crop 6 px further along (a disparity of 6 px everywhere)."""
    y, x = 23 * k % (tex.shape[0] - height), 97 * k % (tex.shape[1] - width - 6)
    left = tex[y:y + height, x:x + width]
    right = tex[y:y + height, x + 6:x + 6 + width]
    return np.rint(left).astype(np.uint8), np.rint(right).astype(np.uint8)


def assert_frames_equal(got, want):
    for name, a, b in zip(frame_mod.StereoFrame._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), f"{name} differs"


@pytest.fixture
def recorder():
    trace.drain()
    trace.enable()
    yield
    trace.disable()
    trace.drain()


# --------------------------------------------------------------------- CPU


class TestGraphKey:
    @pytest.fixture
    def images(self):
        return torch.zeros((96, 192), dtype=torch.uint8), \
            torch.zeros((96, 192), dtype=torch.uint8)

    @pytest.mark.parametrize("setting", [
        *[("orb", f.name) for f in dataclasses.fields(OrbConfig)],
        ("camera", "bf"), ("camera", "fx"),
        ("tracking", "th_high"), ("tracking", "th_low")])
    def test_every_setting_the_body_reads_changes_the_key(self, images, setting):
        group, name = setting
        cfg = small_cfg()
        part = getattr(cfg, group)
        value = getattr(part, name)
        other = (not value) if isinstance(value, bool) else value + 1
        changed = dataclasses.replace(
            cfg, **{group: dataclasses.replace(part, **{name: other})})
        assert frame_mod.graph_key(*images, cfg) != frame_mod.graph_key(*images, changed)

    def test_settings_the_body_does_not_read_leave_the_key(self, images):
        cfg = small_cfg()
        changed = dataclasses.replace(
            cfg, camera=dataclasses.replace(cfg.camera, cx=1.0, cy=2.0, fy=3.0),
            tracking=TrackingConfig(max_frames=3, max_local_points=1024))
        assert frame_mod.graph_key(*images, cfg) == frame_mod.graph_key(*images, changed)

    @pytest.mark.parametrize("what", ["shape", "dtype", "device", "right"])
    def test_images_change_the_key(self, images, what):
        left, right = images
        other = {"shape": (torch.zeros((96, 191), dtype=torch.uint8), right),
                 "dtype": (left.float(), right),
                 "device": (left.to("meta"), right.to("meta")),
                 "right": (left, right.float())}[what]
        cfg = small_cfg()
        assert frame_mod.graph_key(left, right, cfg) != frame_mod.graph_key(*other, cfg)


class TestCpuTakesTheBody:
    @pytest.fixture(scope="class")
    def pair(self):
        img = make_texture(256, seed=5)[:96, :192]
        return (torch.as_tensor(np.rint(img).astype(np.uint8)),
                torch.as_tensor(np.rint(np.roll(img, -4, axis=1)).astype(np.uint8)))

    @pytest.mark.parametrize("use_atlas", [True, False])
    def test_equal_to_the_body_and_nothing_captured(self, pair, use_atlas, monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError("a CPU frame tried to capture a CUDA graph")

        monkeypatch.setattr(frame_mod, "FrontendGraph", refuse)
        monkeypatch.setattr(frame_mod, "_GRAPHS", {})
        cfg = small_cfg(use_atlas=use_atlas)
        got = frame_mod.build_stereo_frame(*pair, cfg)
        assert_frames_equal(got, frame_mod.stereo_frame_body(*pair, cfg))
        assert int(got.valid.sum()) > 50
        assert frame_mod._GRAPHS == {}

    def test_span_reads_graph_zero(self, pair, recorder):
        frame_mod.build_stereo_frame(*pair, small_cfg())
        frame_mod.build_stereo_frame(*pair, small_cfg())
        spans = trace.drain().spans
        front = [s for s in spans if s.name == "track.frontend"]
        assert [s.args for s in front] == [{"graph": 0}, {"graph": 0}]
        assert not [s for s in spans if s.name == "track.frontend_capture"]


class TestProfileSummary:
    def test_frontend_summary(self):
        def span(name, **args):
            return trace.Span(0, name, 0, -1, 0, 1, args)

        warm = [span("track.frontend", graph=0), span("track.frontend_capture"),
                span("track.frontend", graph=1)]
        measured = [span("track.frontend", graph=1), span("track.motion"),
                    span("track.frontend", graph=1), span("track.frontend", graph=0)]
        front = profile_system.GRAPHED["frontend"]
        got = profile_system.graph_summary(warm, measured, *front)
        assert got == dict(spans=3, graph_share=2 / 3, captures_warm=1,
                           captures_measured=0)
        assert profile_system.graph_summary([], [], *front)["graph_share"] is None


# -------------------------------------------------------------------- card


@pytest.fixture
def card(monkeypatch):
    """The card, with an empty graph cache and the launch counters at 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(frame_mod, "_GRAPHS", {})
    kernels.reset_launch_counts()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def texture():
    return make_texture(2048, seed=11)


def kitti_cfg(width: int, height: int, use_atlas: bool = True) -> SlamConfig:
    return SlamConfig(camera=CameraConfig(width=width, height=height),
                      orb=OrbConfig(n_features=2000, use_atlas=use_atlas))


@pytest.mark.cuda
class TestReplayOnTheCard:
    N_FRAMES = 4

    def test_both_sizes_bit_equal_and_unaliased(self, card, texture, recorder):
        """Four frames of each KITTI size: each call equal to the eager
        body on the same images; the first two frames of each size (the
        eager call's and the first replay's) still equal to their twins
        after every later replay; one graph per size."""
        kept = []
        for width, height in SIZES:
            cfg = kitti_cfg(width, height)
            for k in range(self.N_FRAMES):
                left, right = (torch.as_tensor(a).to(card)
                               for a in stereo_pair(width, height, k, texture))
                got = frame_mod.build_stereo_frame(left, right, cfg)
                want = frame_mod.stereo_frame_body(left, right, cfg)
                assert_frames_equal(got, want)
                assert int(got.valid.sum()) > 1000 and int((got.depth > 0).sum()) > 200
                if k < 2:   # the eager call's frame and the first replay's
                    kept.append((got, want))
                for g, w in kept:
                    assert_frames_equal(g, w)
        assert len(frame_mod._GRAPHS) == 2
        shapes = sorted(tuple(key[1]) for key in frame_mod._GRAPHS)
        assert shapes == sorted((h, w) for w, h in SIZES)
        spans = trace.drain().spans
        graph = [s.args["graph"] for s in spans if s.name == "track.frontend"]
        assert graph == ([0] + [1] * (self.N_FRAMES - 1)) * len(SIZES)
        captures = [s.args for s in spans if s.name == "track.frontend_capture"]
        assert captures == [dict(height=h, width=w) for w, h in SIZES]

    def test_stacked_window_views(self, card, texture):
        """Views of a (W, 2, H, Wd) uint8 upload, as the windowed scan
        hands them, replay bit-equal to the body on the same views."""
        width, height = SIZES[1]
        cfg = kitti_cfg(width, height)
        images = torch.as_tensor(np.stack([
            np.stack(stereo_pair(width, height, k, texture))
            for k in range(self.N_FRAMES)])).to(card)
        got = [frame_mod.build_stereo_frame(lr[0], lr[1], cfg) for lr in images]
        for g, lr in zip(got, images):
            assert_frames_equal(g, frame_mod.stereo_frame_body(lr[0], lr[1], cfg))

    @pytest.mark.parametrize("use_atlas", [True, False])
    def test_kernel_launches_counted_on_replay(self, card, texture, use_atlas):
        """One fast_score and one brief_canvas (atlas) or brief_level
        (per-level) launch a frame, the replays included."""
        width, height = SIZES[0]
        cfg = kitti_cfg(width, height, use_atlas)
        for k in range(self.N_FRAMES):
            left, right = (torch.as_tensor(a).to(card)
                           for a in stereo_pair(width, height, k, texture))
            got = frame_mod.build_stereo_frame(left, right, cfg)
        brief = "brief_canvas" if use_atlas else "brief_level"
        assert kernels.launch_counts() == {
            "fast_score": self.N_FRAMES, "brief_canvas": 0, "brief_level": 0,
            "pose_opt": 0, brief: self.N_FRAMES}
        kernels.reset_launch_counts()
        assert_frames_equal(got, frame_mod.stereo_frame_body(left, right, cfg))
