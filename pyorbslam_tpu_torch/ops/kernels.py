"""Hand-written CUDA kernels for Hopper, their wrappers, launch counters
and plain twins.

Three kernels carry the per-frame frontend; they replace the three
Pallas kernels of ``pyorbslam_tpu/ops/pallas_kernels.py``:

* ``fast_score`` (``csrc/fast_score.cu``), FAST-9/16 corner strength over
  a list of images in one launch: the atlas canvas alone
  (:func:`fast_score_map`) or the 16 level images of a stereo frame
  (:func:`fast_score_maps`).  Twin:
  :func:`pyorbslam_tpu_torch.ops.fast.fast_score_map`, once per image.
* ``brief_canvas`` (``csrc/brief_canvas.cu``), steered rBRIEF on the
  blurred canvas (``OrbConfig.use_atlas=True``).  Its block size is an
  argument of the launch (``BRIEF_CANVAS_WARPS`` here), and its library
  also holds an empty kernel for the same grid
  (:func:`brief_canvas_floor_kernel`, a measurement aid).  Twin:
  :func:`brief_descriptors_canvas_ref`.
* ``brief_level`` (``csrc/brief_level.cu``), steered rBRIEF on the
  reflect-padded blurred level images of a frame in one launch
  (``use_atlas=False``; :func:`brief_descriptors_levels`, and
  :func:`brief_descriptors_level` for one image).  Twin:
  :func:`brief_descriptors_levels_ref`, that is
  :func:`pyorbslam_tpu_torch.ops.orb_descriptor.brief_descriptors` once
  per image.

The two multi-image kernels take their image table by value in the
kernel's parameters, at most ``MAX_IMAGES`` = 16 entries (8 levels x left
and right).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  The build runs at
first use (or through :func:`build_kernels`), from the sources in this
package only, into ``pyorbslam_tpu_torch/_build/``; a library's file name
carries the hash of its source and of the shared ``csrc/*.cuh`` headers,
so an edited source is rebuilt.

A wrapper takes its twin only for a tensor on the CPU.  For a CUDA
tensor it launches the kernel on the current stream or raises; there is
no fallback.  ``launches`` on each :class:`CudaKernel` counts the
kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from typing import Dict, List, Sequence

import torch

from pyorbslam_tpu_torch.ops import fast as fast_ops
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BRIEF_REACH = 19   # max |rounded rotated pattern offset| on the canvas
# Warps (keypoints) a block of the brief_canvas launch; the kernel takes any
# block size, and chip_smoke.py times 1, 2, 4 and 8 on the card.
BRIEF_CANVAS_WARPS = 8
MAX_IMAGES = 16    # entries of a multi-image kernel's by-value image table


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


class CudaKernel:
    """One CUDA source, its C entry point and its launch counter."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source            # path relative to the repo root
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces        # file:line of the TPU kernel
        self.launches = 0
        self._lib = None
        self._fn = None

    @property
    def source_path(self) -> str:
        return os.path.join(os.path.dirname(PKG_DIR), self.source)

    @property
    def library_path(self) -> str:
        h = hashlib.sha256()
        for path in [self.source_path,
                     *sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))]:
            with open(path, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"{self.name}_{digest}.so")

    def start_build(self) -> "subprocess.Popen | None":
        """Start nvcc for this kernel unless its library is up to date."""
        lib = self.library_path
        if os.path.exists(lib):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", lib + ".tmp", self.source_path]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: "subprocess.Popen | None") -> str:
        if proc is None:
            return ""
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        os.replace(self.library_path + ".tmp", self.library_path)
        with open(self.library_path + ".log", "w") as f:
            f.write(log)
        return log

    def function(self, symbol: str, argtypes: list):
        """A C launch function of this kernel's library (built and loaded
        at first use); every one takes the stream last and returns the
        CUDA error of its launch."""
        if self._lib is None:
            self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(self.library_path)
        fn = getattr(self._lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def _entry(self):
        if self._fn is None:
            self._fn = self.function(self.symbol, self.argtypes)
        return self._fn

    def _call(self, fn, device: torch.device, *args) -> None:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {rc}")

    def launch(self, device: torch.device, *args) -> None:
        self._call(self._entry(), device, *args)
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int


class _FastImage(ctypes.Structure):
    """``FastImage`` of csrc/fast_score.cu; the launch function fills the
    tile fields."""
    _fields_ = [("img", _P), ("out", _P), ("h", _I), ("w", _I),
                ("tiles_x", _I), ("tile_end", _I)]


class _FastTable(ctypes.Structure):
    _fields_ = [("im", _FastImage * MAX_IMAGES), ("n", _I)]


class _BriefImage(ctypes.Structure):
    """``BriefImage`` of csrc/brief_level.cu."""
    _fields_ = [("img", _P), ("pitch", _I), ("first", _I)]


class _BriefTable(ctypes.Structure):
    _fields_ = [("im", _BriefImage * MAX_IMAGES), ("n", _I)]


FAST_SCORE = CudaKernel(
    "fast_score", "pyorbslam_tpu_torch/csrc/fast_score.cu", "fast_score_launch",
    [ctypes.POINTER(_FastTable), _P],
    replaces="pyorbslam_tpu/ops/pallas_kernels.py:83",
)
BRIEF_CANVAS = CudaKernel(
    "brief_canvas", "pyorbslam_tpu_torch/csrc/brief_canvas.cu",
    "brief_canvas_launch",
    [_P, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    replaces="pyorbslam_tpu/ops/pallas_kernels.py:327",
)
BRIEF_LEVEL = CudaKernel(
    "brief_level", "pyorbslam_tpu_torch/csrc/brief_level.cu",
    "brief_level_launch",
    [ctypes.POINTER(_BriefTable), _P, _P, _P, _P, _P, _I, _P],
    replaces="pyorbslam_tpu/ops/pallas_kernels.py:206",
)
KERNELS: List[CudaKernel] = [FAST_SCORE, BRIEF_CANVAS, BRIEF_LEVEL]


def build_kernels() -> Dict[str, str]:
    """Build every kernel whose library is missing, all nvcc processes at
    once, and load them.  Returns each kernel's nvcc log (empty when the
    library was already built)."""
    procs = [(k, k.start_build()) for k in KERNELS]
    logs = {k.name: k.finish_build(p) for k, p in procs}
    for k in KERNELS:
        k._entry()
    return logs


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def _check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
                device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of the given dtype
    and shape (None in ``shape`` matches any size) on ``device``."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")


def _check_image_list(imgs: Sequence[torch.Tensor], what: str) -> torch.device:
    """Raise unless ``imgs`` holds 1..MAX_IMAGES tensors on one device;
    returns that device."""
    if not 1 <= len(imgs) <= MAX_IMAGES:
        raise ValueError(
            f"{what}: {len(imgs)} images; one launch takes 1 to {MAX_IMAGES} "
            f"(8 pyramid levels x left and right); a frame with more levels "
            f"needs more than one call")
    dev = imgs[0].device
    for i, img in enumerate(imgs):
        if img.device != dev:
            raise ValueError(f"{what}: image {i} is on {img.device}, image 0 on {dev}")
    return dev


def fast_score_maps_kernel(imgs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """One fast_score launch over all of ``imgs`` (CUDA, float32, (H, W),
    contiguous)."""
    dev = _check_image_list(imgs, "fast_score_maps")
    table = _FastTable()
    table.n = len(imgs)
    outs = []
    for i, img in enumerate(imgs):
        if img.numel() == 0:
            raise ValueError(f"imgs[{i}]: empty image {tuple(img.shape)}")
        _check_cuda(img, f"imgs[{i}]", torch.float32, (None, None), dev)
        out = torch.empty_like(img)
        entry = table.im[i]
        entry.img, entry.out = img.data_ptr(), out.data_ptr()
        entry.h, entry.w = img.shape
        outs.append(out)
    FAST_SCORE.launch(dev, ctypes.byref(table))
    return outs


def fast_score_maps(imgs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """FAST-9/16 corner strength of up to 16 float32 (H_i, W_i) images: one
    launch of the CUDA kernel for CUDA tensors, the twin
    ``fast.fast_score_map`` per image for CPU tensors."""
    if _check_image_list(imgs, "fast_score_maps").type == "cpu":
        return [fast_ops.fast_score_map(img) for img in imgs]
    return fast_score_maps_kernel(imgs)


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 corner strength of one float32 (H, W) image (the atlas
    canvas): the one-image case of :func:`fast_score_maps`."""
    return fast_score_maps([img])[0]


def _check_brief_bounds(canvas: torch.Tensor, xy: torch.Tensor) -> None:
    """Raise unless every keypoint keeps all 512 samples on the canvas."""
    hc, wc = canvas.shape
    if xy.shape[0] == 0:
        return
    out = ((xy < BRIEF_REACH).any()
           | (xy[:, 0] >= wc - BRIEF_REACH).any()
           | (xy[:, 1] >= hc - BRIEF_REACH).any())
    if bool(out):
        raise ValueError(
            f"brief_descriptors_canvas: a keypoint lies closer than "
            f"{BRIEF_REACH} px to the edge of the {hc}x{wc} canvas")


def _brief_gather(image: torch.Tensor, xy: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, border: int) -> torch.Tensor:
    """Sampling body of both rBRIEF twins: rotated offsets, one gather
    from ``image`` (whose keypoint coordinates are shifted by ``border``),
    pair compare and bit pack."""
    rows, cols = desc_ops.rotated_offsets_cs(cos, sin)
    samp = desc_ops.gather_patches(image, xy, rows, cols, border=border)
    return desc_ops.pack_bits(samp[:, 0::2] < samp[:, 1::2])


def brief_canvas_gather(blur_canvas: torch.Tensor, xy: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The brief_canvas twin after its cos and sin (canvas coordinates)."""
    return _brief_gather(blur_canvas, xy, cos, sin, border=0)


def brief_level_gather(padded_blurred: torch.Tensor, xy: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The brief_level twin after its cos and sin: the arithmetic of
    ``orb_descriptor.brief_descriptors`` on a level padded by ``BORDER``."""
    return _brief_gather(padded_blurred, xy, cos, sin, border=desc_ops.BORDER)


@lru_cache(maxsize=4)
def _pattern_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(desc_ops.brief_pattern(), dtype=torch.float32,
                           device=device).contiguous()


def brief_canvas_kernel(blur_canvas: torch.Tensor, xy: torch.Tensor,
                        cos: torch.Tensor, sin: torch.Tensor,
                        warps: int = BRIEF_CANVAS_WARPS) -> torch.Tensor:
    """Launch the brief_canvas kernel on CUDA tensors with ``warps`` warps
    a block (no bounds check: callers go through
    :func:`brief_descriptors_canvas`)."""
    dev = blur_canvas.device
    n = xy.shape[0]
    _check_cuda(blur_canvas, "blur_canvas", torch.float32, (None, None), dev)
    _check_cuda(xy, "xy", torch.int32, (n, 2), dev)
    _check_cuda(cos, "cos", torch.float32, (n,), dev)
    _check_cuda(sin, "sin", torch.float32, (n,), dev)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    BRIEF_CANVAS.launch(
        dev, blur_canvas.data_ptr(), blur_canvas.shape[1], xy.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), _pattern_on(dev).data_ptr(),
        out.data_ptr(), n, warps)
    return out


def brief_canvas_floor_kernel(device: torch.device, n: int,
                              warps: int = BRIEF_CANVAS_WARPS) -> None:
    """Launch an empty kernel on brief_canvas' grid for ``n`` keypoints:
    what the card takes to start and retire that grid, the floor under the
    kernel's own time.  A measurement aid; it counts as no launch."""
    fn = BRIEF_CANVAS.function("brief_canvas_floor_launch", [_I, _I, _P])
    BRIEF_CANVAS._call(fn, device, n, warps)


def brief_descriptors_canvas_ref(
    blur_canvas: torch.Tensor, xy: torch.Tensor, angle_deg: torch.Tensor
) -> torch.Tensor:
    """Plain twin of the brief_canvas kernel (the JAX package's gather
    branch, ``atlas.py:296-307``): blur_canvas (Hc, Wc) float32, xy (N, 2)
    int32 canvas coords, angle (N,) degrees -> (N, 8) int32 words."""
    _check_brief_bounds(blur_canvas, xy)
    cos, sin = desc_ops.cos_sin(angle_deg)
    return brief_canvas_gather(blur_canvas, xy, cos, sin)


def brief_descriptors_canvas(
    blur_canvas: torch.Tensor, xy: torch.Tensor, angle_deg: torch.Tensor,
    check_bounds: bool = True,
) -> torch.Tensor:
    """Steered rBRIEF on the canvas: the CUDA kernel for CUDA tensors, the
    twin :func:`brief_descriptors_canvas_ref` for CPU tensors.  cos and
    sin are computed here in torch, exactly as the twin computes them.

    The bounds check reads one flag back from the device, which makes the
    host wait for everything queued before it.  A caller whose keypoints
    keep the pattern's reach from the canvas edge by construction (the
    atlas layout) passes ``check_bounds=False``."""
    if blur_canvas.device.type == "cpu":
        return brief_descriptors_canvas_ref(blur_canvas, xy, angle_deg)
    if check_bounds:
        _check_brief_bounds(blur_canvas, xy)
    cos, sin = desc_ops.cos_sin(angle_deg)
    return brief_canvas_kernel(blur_canvas, xy, cos.contiguous(), sin.contiguous())


def _level_shape(padded_blurred: torch.Tensor) -> tuple:
    return (padded_blurred.shape[0] - 2 * desc_ops.BORDER,
            padded_blurred.shape[1] - 2 * desc_ops.BORDER)


def _check_levels_bounds(padded_blurred: Sequence[torch.Tensor],
                         counts: Sequence[int], xy_all: torch.Tensor) -> None:
    """Raise unless every keypoint lies inside its level: the pad is
    ``BORDER`` = 19 px and the rotated pattern reaches 19, so a keypoint
    anywhere in the level keeps all 512 samples on the padded image.
    (``select_keypoints`` fills invalid slots with in-level pixels too.)
    ``xy_all`` holds the ``counts[i]`` keypoints of each image in turn; one
    comparison and one host read serve all images."""
    if xy_all.shape[0] == 0:
        return
    shapes = [_level_shape(p) for p in padded_blurred]
    limit = torch.tensor([[w, h] for h, w in shapes], dtype=torch.int32)
    limit = limit.repeat_interleave(torch.tensor(list(counts)), dim=0)
    outside = ((xy_all < 0) | (xy_all >= limit.to(xy_all.device))).any(dim=1)
    if bool(outside.any()):
        k = int(outside.nonzero()[0])
        ends = torch.tensor(list(counts)).cumsum(0)
        i = int(torch.searchsorted(ends, k, right=True))
        h, w = shapes[i]
        raise ValueError(f"brief_descriptors_levels: a keypoint of image {i} "
                         f"lies outside the {h}x{w} level")


def _check_level_bounds(padded_blurred: torch.Tensor, xy: torch.Tensor) -> None:
    """The one-image case of :func:`_check_levels_bounds`."""
    _check_levels_bounds([padded_blurred], [xy.shape[0]], xy)


def brief_levels_kernel(images: Sequence[torch.Tensor], counts: Sequence[int],
                        xy: torch.Tensor, cos: torch.Tensor,
                        sin: torch.Tensor) -> torch.Tensor:
    """One brief_level launch on CUDA tensors: ``images[i]`` holds the
    ``counts[i]`` keypoints that follow those of image ``i - 1`` in the
    concatenated ``xy`` (N, 2), ``cos`` and ``sin`` (N,).  No bounds check:
    callers go through :func:`brief_descriptors_levels`."""
    dev = _check_image_list(images, "brief_descriptors_levels")
    n = xy.shape[0]
    if len(counts) != len(images) or sum(counts) != n:
        raise ValueError(f"counts {list(counts)} do not describe {len(images)} "
                         f"images and {n} keypoints")
    _check_cuda(xy, "xy", torch.int32, (n, 2), dev)
    _check_cuda(cos, "cos", torch.float32, (n,), dev)
    _check_cuda(sin, "sin", torch.float32, (n,), dev)
    table = _BriefTable()
    table.n = len(images)
    first = 0
    for i, img in enumerate(images):
        _check_cuda(img, f"padded_blurred[{i}]", torch.float32, (None, None), dev)
        entry = table.im[i]
        entry.img, entry.pitch, entry.first = img.data_ptr(), img.shape[1], first
        first += counts[i]
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    BRIEF_LEVEL.launch(dev, ctypes.byref(table), xy.data_ptr(), cos.data_ptr(),
                       sin.data_ptr(), _pattern_on(dev).data_ptr(), out.data_ptr(), n)
    return out


def brief_level_kernel(padded_blurred: torch.Tensor, xy: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The one-image case of :func:`brief_levels_kernel`."""
    return brief_levels_kernel([padded_blurred], [xy.shape[0]], xy, cos, sin)


def brief_descriptors_levels_ref(
    padded_blurred: Sequence[torch.Tensor], xy: Sequence[torch.Tensor],
    angle_deg: Sequence[torch.Tensor]
) -> torch.Tensor:
    """Plain twin of the brief_level kernel:
    ``orb_descriptor.brief_descriptors`` per image (an image may have no
    keypoints), concatenated."""
    return torch.cat([
        desc_ops.brief_descriptors(p, k, a) if k.shape[0]
        else torch.empty((0, 8), dtype=torch.int32, device=p.device)
        for p, k, a in zip(padded_blurred, xy, angle_deg)])


def brief_descriptors_levels(
    padded_blurred: Sequence[torch.Tensor], xy: Sequence[torch.Tensor],
    angle_deg: Sequence[torch.Tensor], check_bounds: bool = True,
) -> torch.Tensor:
    """Steered rBRIEF on up to 16 level images: ``padded_blurred[i]`` is
    (H_i + 38, W_i + 38) float32 (reflect pad of ``BORDER``), ``xy[i]``
    (N_i, 2) int32 level coords, ``angle_deg[i]`` (N_i,) degrees ->
    (sum N_i, 8) int32 words in the order given.  One launch of the CUDA
    kernel for CUDA tensors, the twin :func:`brief_descriptors_levels_ref`
    for CPU tensors.  cos and sin are computed here in torch, exactly as
    the twin computes them.

    The bounds check sends the level sizes to the device and reads one
    flag back, which makes the host wait for everything queued before it.
    A caller whose keypoints lie inside their levels by construction (the
    extractor: ``select_keypoints`` keeps every slot 16 px inside) passes
    ``check_bounds=False``."""
    dev = _check_image_list(padded_blurred, "brief_descriptors_levels")
    if not len(xy) == len(angle_deg) == len(padded_blurred):
        raise ValueError(
            f"brief_descriptors_levels: {len(padded_blurred)} images, "
            f"{len(xy)} keypoint arrays, {len(angle_deg)} angle arrays")
    for i, k in enumerate(xy):
        if k.device != dev or angle_deg[i].device != dev:
            raise ValueError(f"brief_descriptors_levels: keypoints of image {i} "
                             f"are not on {dev}")
    counts = [k.shape[0] for k in xy]
    xy_all = torch.cat(list(xy))
    if check_bounds:
        _check_levels_bounds(padded_blurred, counts, xy_all)
    if dev.type == "cpu":
        return brief_descriptors_levels_ref(padded_blurred, xy, angle_deg)
    cos, sin = desc_ops.cos_sin(torch.cat(list(angle_deg)))
    return brief_levels_kernel(padded_blurred, counts, xy_all, cos.contiguous(),
                               sin.contiguous())


def brief_descriptors_level(
    padded_blurred: torch.Tensor, xy: torch.Tensor, angle_deg: torch.Tensor
) -> torch.Tensor:
    """Steered rBRIEF on one level: the one-image case of
    :func:`brief_descriptors_levels`."""
    return brief_descriptors_levels([padded_blurred], [xy], [angle_deg])
