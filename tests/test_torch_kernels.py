"""The CUDA kernel wrappers of the PyTorch port on the CPU: each wrapper
returns its plain twin's result for a CPU tensor without launching,
building or loading anything, refuses tensors it cannot launch on, and
the port imports with JAX unavailable."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pyorbslam_tpu_torch.ops import fast as fast_ops
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops
from pyorbslam_tpu_torch.optim import pose_opt

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
            "fast_score": 0, "brief_canvas": 0, "brief_level": 0, "pose_opt": 0}

    @pytest.mark.parametrize("case", [
        dict(n=300, noise_px=0.3, outlier_frac=0.15),
        dict(n=256, noise_px=0.5, outlier_frac=0.2, active_frac=0.4),
        dict(n=5, active_frac=0.0)], ids=["noisy", "sparse", "too_few"])
    def test_pose_opt_wrapper_returns_twin_without_launch(self, case, no_build):
        """For CPU tensors the wrapper is the twin: every output equal, no
        launch and no build."""
        args = pose_opt.synthetic_problem(4, **case)
        got = pose_opt.pose_optimization(*args)
        want = pose_opt.pose_optimization_ref(*args)
        assert got.Tcw.dtype == torch.float32 and got.Tcw.shape == (4, 4)
        assert got.inliers.dtype == torch.bool and got.inliers.shape == (case["n"],)
        assert got.num_inliers.dtype == torch.int32 and got.num_inliers.shape == ()
        assert got.chi2.dtype == torch.float32 and got.chi2.shape == (case["n"],)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if case.get("active_frac") == 0.0:
            assert torch.equal(got.Tcw, args[0])
        assert kernels.POSE_OPT.launches == 0

    def test_registry_lists_three_kernels(self):
        """The three frontend kernels, each replacing a Pallas kernel, then
        the pose optimizer, which replaces the JAX package's LM loop."""
        assert [k.name for k in kernels.KERNELS] == [
            "fast_score", "brief_canvas", "brief_level", "pose_opt"]
        assert [k.replaces.rsplit(":", 1)[1] for k in kernels.KERNELS] == [
            "83", "327", "206", "132"]
        assert [k.replaces.rsplit(":", 1)[0] for k in kernels.KERNELS] == [
            "pyorbslam_tpu/ops/pallas_kernels.py"] * 3 + [
            "pyorbslam_tpu/optim/pose_opt.py"]
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

    @pytest.mark.parametrize("fault", [
        "mixed_devices", "wrong_dtype", "float_mask", "wrong_shape", "ragged",
        "non_contiguous", "bad_camera", "negative_rounds", "too_many_edges",
        "not_cuda"])
    def test_pose_opt_refuses(self, fault, no_build):
        """The pose optimizer raises on what its kernel cannot take, on the
        CPU path too (the twin would run it), and never launches; the meta
        device stands in for a card."""
        args = list(pose_opt.synthetic_problem(5, 64))
        meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
        kw = {}
        call = pose_opt.pose_optimization
        if fault == "mixed_devices":
            args[1], match = meta(args[1]), "Xw is on meta, Tcw0 on cpu"
        elif fault == "wrong_dtype":
            args[2], match = args[2].double(), "obs: expected torch.float32"
        elif fault == "float_mask":
            args[4], match = args[4].float(), "active0: expected torch.bool"
        elif fault == "wrong_shape":
            args[0], match = args[0][:3].contiguous(), r"Tcw0: expected shape \(4, 4\)"
        elif fault == "ragged":
            args[3], match = args[3][:63], r"inv_sigma2: expected shape \(64,\)"
        elif fault == "non_contiguous":
            args[1] = args[1].t().contiguous().t()
            match = "Xw: expected a contiguous tensor"
        elif fault == "bad_camera":
            args[5], match = args[5][:4], r"cam: expected shape \(5,\)"
        elif fault == "negative_rounds":
            kw, match = dict(rounds=-1), "rounds -1"
        elif fault == "too_many_edges":
            n = kernels.POSE_OPT_MAX_EDGES + 1
            args = [meta(args[0]), torch.empty((n, 3), device="meta"),
                    torch.empty((n, 3), device="meta"), torch.empty(n, device="meta"),
                    torch.empty(n, dtype=torch.bool, device="meta"), meta(args[5])]
            match = f"N <= {kernels.POSE_OPT_MAX_EDGES}"
        else:
            args = [meta(a) for a in args]
            call = lambda *a: kernels.pose_opt_kernel(*a, 4, 10, pose_opt.CHI2_STEREO)
            match = "expected CUDA tensors, got meta"
        with pytest.raises(ValueError, match=match):
            call(*args, **kw)
        assert kernels.POSE_OPT.launches == 0

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
        """What the kernel replaces (a Pallas kernel, or none and why it was
        added), what bounds it on the card, what its design does."""
        with open(kernel.source_path) as f:
            text = f.read()
        replaced = {"fast_score": ("Replaces the TPU kernel", "fast_score_map_pallas"),
                    "brief_canvas": ("Replaces the TPU kernel",
                                     "brief_descriptors_canvas"),
                    "brief_level": ("Replaces the TPU kernel",
                                    "brief_descriptors_pallas"),
                    "pose_opt": ("Replaces no TPU kernel", "fori_loop")}[kernel.name]
        assert all(phrase in text for phrase in replaced)
        assert "What bounds it" in text and "What the design does" in text
        assert 'extern "C"' in text

    def test_pose_opt_binding_matches_the_source(self):
        """The ctypes argument list of pose_opt's launch function is the C
        signature's (pointers, ints, the double gate, the stream last), and
        the largest N the wrapper lets through is the source's."""
        with open(kernels.POSE_OPT.source_path) as f:
            text = f.read()
        params = re.search(r"int pose_opt_launch\(([^)]*)\)", text).group(1)
        kinds = [("double" if "double" in p else "int") if "*" not in p and
                 "cudaStream_t" not in p else "ptr" for p in params.split(",")]
        ctype = {"ptr": kernels.ctypes.c_void_p, "int": kernels.ctypes.c_int,
                 "double": kernels.ctypes.c_double}
        assert kernels.POSE_OPT.argtypes == [ctype[k] for k in kinds]
        threads = int(re.search(r"constexpr int kThreads = (\d+);", text).group(1))
        per = int(re.search(r"constexpr int kMaxEdgesPerThread = (\d+);", text).group(1))
        assert kernels.POSE_OPT_MAX_EDGES == threads * per


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


# (case, problem): the cells' 2048 slots with ~40% active and 20% outliers,
# bench.py's 8000-feature slots beyond them, more edges than shared memory
# holds (read from device memory), a clean and a noisy small problem, and a
# frame with fewer than 3 active edges
POSE_CASES = {
    "clean300": dict(n=300, noise_px=0.0, pose_err=0.3),
    "noisy300": dict(n=300, noise_px=0.5, outlier_frac=0.1),
    "sparse2048": dict(n=2048, noise_px=0.5, outlier_frac=0.2, active_frac=0.4),
    "dense8192": dict(n=8192, noise_px=0.5, outlier_frac=0.2, active_frac=0.6),
    "unstaged12000": dict(n=12000, noise_px=0.5, outlier_frac=0.2, active_frac=0.5),
    "too_few": dict(n=2048, active_frac=0.001),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(POSE_CASES))
def test_pose_opt_kernel_equals_twin_on_the_card(case):
    """The kernel against its twin on the same CUDA tensors.  Tolerances:
    the kernel sums in another order, so the poses agree to float32
    rounding of a converged LM (entries within 1e-4, rotation and metres);
    an edge whose twin chi2 lies within 1% of the 7.815 gate may fall on
    either side, so the masks may differ there alone and ``num_inliers`` by
    at most their count; chi2 follows the pose (1e-4 m at 4-40 m is under
    0.01 px, 1e-2 relative on a residual of tens of pixels)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the pose_opt kernel runs only on a card")
    dev = torch.device("cuda", 0)
    args = pose_opt.synthetic_problem(11, device=dev, **POSE_CASES[case])
    before = kernels.POSE_OPT.launches
    got = pose_opt.pose_optimization(*args)
    torch.cuda.synchronize()
    assert kernels.POSE_OPT.launches == before + 1
    want = pose_opt.pose_optimization_ref(*args)
    assert kernels.POSE_OPT.launches == before + 1
    assert float((got.Tcw - want.Tcw).abs().max()) < 1e-4
    near = ((want.chi2 - pose_opt.CHI2_STEREO).abs()
            <= 0.01 * pose_opt.CHI2_STEREO) & args[4]
    differ = got.inliers != want.inliers
    assert not bool((differ & ~near).any())
    assert abs(int(got.num_inliers) - int(want.num_inliers)) <= int(near.sum())
    assert int(got.num_inliers) == int(got.inliers.sum())
    torch.testing.assert_close(got.chi2, want.chi2, rtol=1e-2, atol=1e-2)
    if case == "too_few":
        assert int(args[4].sum()) < 3 and torch.equal(got.Tcw, args[0])


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
