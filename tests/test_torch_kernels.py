"""The CUDA kernel wrappers of the PyTorch port on the CPU: each wrapper
returns its plain twin's result for a CPU tensor without launching,
building or loading anything, refuses tensors it cannot launch on, and
the port imports with JAX unavailable."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyorbslam_tpu_torch.ops import fast as fast_ops
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def canvas():
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.integers(0, 256, (96, 160)).astype(np.float32))


@pytest.fixture
def keypoints():
    rng = np.random.default_rng(1)
    xy = np.stack([rng.integers(19, 160 - 19, 64),
                   rng.integers(19, 96 - 19, 64)], 1).astype(np.int32)
    ang = rng.uniform(0, 360, 64).astype(np.float32)
    return torch.as_tensor(xy), torch.as_tensor(ang)


@pytest.fixture
def level_images():
    """A 3-level pyramid of a 160x96 image: (level images, padded blurred
    level images, 64 keypoints and angles a level), from a numpy seed."""
    rng = np.random.default_rng(21)
    img = torch.as_tensor(rng.uniform(0, 255, (96, 160)).astype(np.float32))
    levels = [l.contiguous() for l in pyr_ops.build_pyramid(img, 1.2, 3)]
    padded = [pyr_ops.reflect_pad(pyr_ops.gaussian_blur(l), desc_ops.BORDER).contiguous()
              for l in levels]
    xy = [torch.as_tensor(np.stack([rng.integers(0, l.shape[1], 64),
                                    rng.integers(0, l.shape[0], 64)], 1).astype(np.int32))
          for l in levels]
    ang = [torch.as_tensor(rng.uniform(0, 360, 64).astype(np.float32)) for _ in levels]
    return levels, padded, xy, ang


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything starts nvcc or loads a shared library."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU run tried to build or load a kernel")

    monkeypatch.setattr(subprocess, "Popen", refuse)
    monkeypatch.setattr(kernels.ctypes, "CDLL", refuse)
    kernels.reset_launch_counts()
    yield
    assert all(k._fn is None for k in kernels.KERNELS)


class TestCpuWrappers:
    def test_fast_wrapper_returns_twin_without_launch(self, canvas, no_build):
        got = kernels.fast_score_map(canvas)
        assert torch.equal(got, fast_ops.fast_score_map(canvas))
        assert kernels.FAST_SCORE.launches == 0

    def test_brief_wrapper_returns_twin_without_launch(self, canvas, keypoints,
                                                       no_build):
        xy, ang = keypoints
        got = kernels.brief_descriptors_canvas(canvas, xy, ang)
        assert got.dtype == torch.int32 and got.shape == (64, 8)
        assert torch.equal(got, kernels.brief_descriptors_canvas_ref(canvas, xy, ang))
        assert kernels.BRIEF_CANVAS.launches == 0

    def test_level_brief_wrapper_returns_twin_without_launch(self, canvas,
                                                             keypoints, no_build):
        xy, ang = keypoints
        padded = pyr_ops.reflect_pad(canvas, desc_ops.BORDER)
        got = kernels.brief_descriptors_level(padded, xy, ang)
        assert got.dtype == torch.int32 and got.shape == (64, 8)
        assert torch.equal(got, desc_ops.brief_descriptors(padded, xy, ang))
        cos, sin = desc_ops.cos_sin(ang)
        assert torch.equal(got, kernels.brief_level_gather(padded, xy, cos, sin))
        assert kernels.BRIEF_LEVEL.launches == 0

    def test_fast_maps_wrapper_returns_twins_without_launch(self, level_images,
                                                            no_build):
        levels = level_images[0]
        got = kernels.fast_score_maps(levels)
        assert len(got) == 3
        for g, l in zip(got, levels):
            assert g.shape == l.shape
            assert torch.equal(g, fast_ops.fast_score_map(l))
        assert torch.equal(kernels.fast_score_map(levels[1]), got[1])
        assert kernels.FAST_SCORE.launches == 0

    def test_levels_brief_wrapper_returns_twin_without_launch(self, level_images,
                                                              no_build):
        _, padded, xy, ang = level_images
        got = kernels.brief_descriptors_levels(padded, xy, ang)
        assert got.dtype == torch.int32 and got.shape == (3 * 64, 8)
        assert torch.equal(got, kernels.brief_descriptors_levels_ref(padded, xy, ang))
        for i in range(3):
            one = kernels.brief_descriptors_level(padded[i], xy[i], ang[i])
            assert torch.equal(got[64 * i: 64 * (i + 1)], one)
            assert torch.equal(one, desc_ops.brief_descriptors(padded[i], xy[i], ang[i]))
        assert kernels.BRIEF_LEVEL.launches == 0

    def test_levels_brief_takes_an_image_without_keypoints(self, level_images,
                                                           no_build):
        _, padded, xy, ang = level_images
        xy[1], ang[1] = xy[1][:0], ang[1][:0]
        got = kernels.brief_descriptors_levels(padded, xy, ang)
        assert got.shape == (2 * 64, 8)
        assert torch.equal(got[64:], desc_ops.brief_descriptors(padded[2], xy[2], ang[2]))
        assert kernels.BRIEF_LEVEL.launches == 0

    @pytest.mark.parametrize("use_atlas", [True, False])
    def test_cpu_frame_build_never_builds(self, no_build, use_atlas):
        from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
        from pyorbslam_tpu_torch.io.synthetic import make_texture
        from pyorbslam_tpu_torch.slam.frame import build_stereo_frame

        img = make_texture(256, seed=5)[:96, :192]
        cfg = SlamConfig(camera=CameraConfig(width=192, height=96),
                         orb=OrbConfig(n_features=300, n_levels=3,
                                       use_atlas=use_atlas))
        frame = build_stereo_frame(torch.as_tensor(img),
                                   torch.as_tensor(np.roll(img, -4, axis=1)), cfg)
        assert int(frame.valid.sum()) > 50
        assert kernels.launch_counts() == {
            "fast_score": 0, "brief_canvas": 0, "brief_level": 0}

    def test_registry_lists_three_kernels(self):
        assert [k.name for k in kernels.KERNELS] == [
            "fast_score", "brief_canvas", "brief_level"]
        assert [k.replaces.rsplit(":", 1)[1] for k in kernels.KERNELS] == [
            "83", "327", "206"]
        for k in kernels.KERNELS:
            assert os.path.exists(k.source_path)
            assert os.path.dirname(k.library_path) == kernels.BUILD_DIR


class TestNoFallback:
    @pytest.mark.parametrize("which", ["fast", "brief", "brief_level"])
    def test_non_cpu_tensor_is_refused(self, which, no_build):
        """A tensor the kernel cannot take raises: nothing falls back to
        the twin off the CPU (the meta device stands in for a card)."""
        meta = torch.empty((96, 160), device="meta")
        with pytest.raises(ValueError):
            if which == "fast":
                kernels.fast_score_map(meta)
            else:
                launch = (kernels.brief_canvas_kernel if which == "brief"
                          else kernels.brief_level_kernel)
                launch(
                    meta, torch.empty((4, 2), dtype=torch.int32, device="meta"),
                    torch.empty(4, device="meta"), torch.empty(4, device="meta"))

    @pytest.mark.parametrize("fault", [
        "too_many_images", "no_image", "mixed_devices", "wrong_dtype",
        "non_contiguous", "empty_image"])
    def test_fast_maps_refuses(self, fault, level_images, no_build):
        """What the multi-image FAST wrapper cannot launch on raises, on
        the CPU path where the table size binds too (the meta device
        stands in for a card)."""
        levels = level_images[0]
        meta = [torch.empty(l.shape, device="meta") for l in levels]
        imgs, match = {
            "too_many_images": (levels * 6, "18 images"),
            "no_image": ([], "0 images"),
            "mixed_devices": ([levels[0], meta[1]], "image 1 is on meta"),
            "wrong_dtype": ([meta[0].to(torch.float64)], "expected torch.float32"),
            "non_contiguous": ([meta[0].t()], "contiguous"),
            "empty_image": ([meta[0][:0]], "empty image"),
        }[fault]
        with pytest.raises(ValueError, match=match):
            kernels.fast_score_maps(imgs)
        assert kernels.FAST_SCORE.launches == 0

    @pytest.mark.parametrize("fault", [
        "too_many_images", "mixed_devices", "keypoints_elsewhere", "wrong_dtype",
        "non_contiguous", "keypoint_outside", "ragged_lists", "bad_counts"])
    def test_levels_brief_refuses(self, fault, level_images, no_build):
        _, padded, xy, ang = level_images
        meta = lambda ts: [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in ts]
        if fault == "too_many_images":
            call = lambda: kernels.brief_descriptors_levels(padded * 6, xy * 6, ang * 6)
            match = "18 images"
        elif fault == "mixed_devices":
            call = lambda: kernels.brief_descriptors_levels(
                [padded[0], meta(padded)[1], padded[2]], xy, ang)
            match = "image 1 is on meta"
        elif fault == "keypoints_elsewhere":
            call = lambda: kernels.brief_descriptors_levels(meta(padded), xy, ang)
            match = "keypoints of image 0 are not on meta"
        elif fault == "wrong_dtype":
            call = lambda: kernels.brief_levels_kernel(
                meta(padded), [64] * 3, meta([torch.cat(xy).to(torch.int64)])[0],
                *meta([torch.cat(ang)] * 2))
            match = "expected torch.int32"
        elif fault == "non_contiguous":
            call = lambda: kernels.brief_levels_kernel(
                meta(padded)[:1], [64],
                torch.empty((2, 64), dtype=torch.int32, device="meta").t(),
                *meta([ang[0], ang[0]]))
            match = "xy: expected a contiguous tensor"
        elif fault == "keypoint_outside":
            xy[1][5] = torch.tensor([int(padded[1].shape[1]) - 38, 3])
            call = lambda: kernels.brief_descriptors_levels(padded, xy, ang)
            match = "a keypoint of image 1 lies outside"
        elif fault == "ragged_lists":
            call = lambda: kernels.brief_descriptors_levels(padded, xy[:2], ang)
            match = "3 images, 2 keypoint arrays"
        else:
            call = lambda: kernels.brief_levels_kernel(
                meta(padded), [64, 64, 63], *meta([torch.cat(xy), torch.cat(ang),
                                                   torch.cat(ang)]))
            match = "do not describe 3 images and 192 keypoints"
        with pytest.raises(ValueError, match=match):
            call()
        assert kernels.BRIEF_LEVEL.launches == 0

    def test_image_tables_match_the_sources(self):
        """The by-value image tables as ctypes lays them out are the
        structs of the CUDA sources: 16 entries, the sizes nvcc gives."""
        assert kernels.MAX_IMAGES == 16
        assert kernels.ctypes.sizeof(kernels._FastImage) == 32
        assert kernels.ctypes.sizeof(kernels._FastTable) == 16 * 32 + 8
        assert kernels.ctypes.sizeof(kernels._BriefImage) == 16
        assert kernels.ctypes.sizeof(kernels._BriefTable) == 16 * 16 + 8
        for k, struct in ((kernels.FAST_SCORE, "FastTable"),
                          (kernels.BRIEF_LEVEL, "BriefTable")):
            with open(k.source_path) as f:
                text = f.read()
            assert "constexpr int kMaxImages = 16;" in text
            assert f"const __grid_constant__ {struct} tab" in text

    def test_level_brief_rejects_keypoints_outside_the_level(self, canvas,
                                                             keypoints):
        """The bounds check the CUDA path runs before it launches."""
        xy, _ = keypoints
        padded = pyr_ops.reflect_pad(canvas, desc_ops.BORDER)
        kernels._check_level_bounds(padded, xy)
        edge = xy.clone()
        edge[0] = torch.tensor([159, 95])
        edge[1] = torch.tensor([0, 0])
        kernels._check_level_bounds(padded, edge)     # any level pixel is legal
        for bad_xy in ([160, 10], [10, 96], [-1, 5]):
            bad = xy.clone()
            bad[3] = torch.tensor(bad_xy)
            with pytest.raises(ValueError, match="outside the 96x160 level"):
                kernels._check_level_bounds(padded, bad)

    def test_brief_rejects_keypoints_near_the_edge(self, canvas, keypoints):
        xy, ang = keypoints
        bad = xy.clone()
        bad[3, 0] = 160 - 19
        with pytest.raises(ValueError, match="closer than 19 px"):
            kernels.brief_descriptors_canvas(canvas, bad, ang)


class TestBuild:
    def test_nvcc_command_and_source_hash(self, monkeypatch, tmp_path):
        """The build targets sm_90a with a plain C interface, writes into
        the build directory under a name carrying the source hash, and a
        changed source gets a new library name."""
        started = []

        class FakeProc:
            returncode = 0

            def __init__(self, cmd, **kw):
                started.append(cmd)

            def communicate(self):
                out = started[-1][started[-1].index("-o") + 1]
                open(out, "w").close()
                return "ptxas info: Used 32 registers", ""

        monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
        monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
        monkeypatch.setattr(kernels.subprocess, "Popen", FakeProc)
        src = tmp_path / "k.cu"
        src.write_text("// v1\n")
        monkeypatch.setattr(kernels, "CSRC_DIR", str(tmp_path))
        k = kernels.CudaKernel("k", str(src), "k_launch", [], replaces="x:1")
        lib1 = k.library_path
        log = k.finish_build(k.start_build())
        cmd = started[0]
        assert cmd[0] == "nvcc" and cmd[-1] == str(src)
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
        assert os.path.exists(lib1) and "registers" in log
        assert k.start_build() is None          # up to date: no rebuild
        src.write_text("// v2\n")
        lib2 = k.library_path
        assert lib2 != lib1
        # a shared header is part of the hash too
        (tmp_path / "common.cuh").write_text("// h\n")
        assert k.library_path != lib2

    @pytest.mark.parametrize("kernel", kernels.KERNELS, ids=lambda k: k.name)
    def test_source_carries_its_note(self, kernel):
        with open(kernel.source_path) as f:
            text = f.read()
        pallas_fn = {"fast_score": "fast_score_map_pallas",
                     "brief_canvas": "brief_descriptors_canvas",
                     "brief_level": "brief_descriptors_pallas"}[kernel.name]
        assert "Replaces the TPU kernel" in text and pallas_fn in text
        assert "What bounds it" in text and "What the design does" in text
        assert 'extern "C"' in text


@pytest.mark.cuda
def test_level_brief_kernel_equals_twin_on_the_card():
    """Needs a CUDA device (run with ``pytest -m cuda`` on a GPU machine;
    ``python3 chip_smoke.py`` makes the same check at the path's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the brief_level kernel runs only on a card")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(3)
    img = torch.as_tensor(rng.uniform(0, 255, (96, 160)).astype(np.float32), device=dev)
    xy = torch.as_tensor(np.stack([rng.integers(0, 160, 200),
                                   rng.integers(0, 96, 200)], 1).astype(np.int32),
                         device=dev)
    ang = torch.as_tensor(rng.uniform(0, 360, 200).astype(np.float32), device=dev)
    padded = pyr_ops.reflect_pad(img, desc_ops.BORDER).contiguous()
    before = kernels.BRIEF_LEVEL.launches
    got = kernels.brief_descriptors_level(padded, xy, ang)
    assert kernels.BRIEF_LEVEL.launches == before + 1
    assert torch.equal(got, desc_ops.brief_descriptors(padded, xy, ang))


def test_imports_without_jax():
    """The port and every submodule import with JAX unavailable, and none
    of them pulls in the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import pyorbslam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, 'pyorbslam_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "want = ['slam.system', 'slam.slam_map', 'slam.local_mapping', 'slam.kf_ring',\n"
        "        'optim.ba', 'ops.triangulation', 'place.vocabulary', 'place.keyframe_db',\n"
        "        'native.mapcore_ffi', 'optim.epnp', 'io.kitti', 'stereo_kitti',\n"
        "        'utils.host_read', 'geometry.sim3', 'optim.horn', 'optim.sim3_opt',\n"
        "        'optim.pose_graph', 'optim.ba_cg', 'slam.loop_closing',\n"
        "        'tools.dispatch_timing', 'utils.checkpoint', 'parallel.dist_ba',\n"
        "        'parallel.dist_pose_graph', 'parallel.multihost', 'viz.live_viewer',\n"
        "        'viz.drawer', 'io.render_torch', 'tools.multihost_dryrun',\n"
        "        'tools.eval_scale', 'tools.eval_synth', 'bench',\n"
        "        'tools.make_kitti_synth', 'tools.train_vocab', 'tools.scaling_report',\n"
        "        'utils.device']\n"
        "missing = [w for w in want if 'pyorbslam_tpu_torch.' + w not in names]\n"
        "assert not missing, missing\n"
        "assert not any(n == 'pyorbslam_tpu' or n.startswith('pyorbslam_tpu.')\n"
        "               for n in sys.modules), 'JAX package imported'\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
