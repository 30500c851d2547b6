"""Hand-written CUDA kernels for Hopper, their wrappers, launch counters
and plain twins.

Three kernels carry the per-frame frontend; they replace the three
Pallas kernels of ``pyorbslam_tpu/ops/pallas_kernels.py``:

* ``fast_score`` (``csrc/fast_score.cu``), FAST-9/16 corner strength over
  the atlas canvas or one pyramid level.  Twin:
  :func:`pyorbslam_tpu_torch.ops.fast.fast_score_map`.
* ``brief_canvas`` (``csrc/brief_canvas.cu``), steered rBRIEF on the
  blurred canvas (``OrbConfig.use_atlas=True``).  Twin:
  :func:`brief_descriptors_canvas_ref`.
* ``brief_level`` (``csrc/brief_level.cu``), steered rBRIEF on one level's
  reflect-padded blurred image (``use_atlas=False``).  Twin:
  :func:`pyorbslam_tpu_torch.ops.orb_descriptor.brief_descriptors`.

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
from typing import Dict, List

import torch

from pyorbslam_tpu_torch.ops import fast as fast_ops
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

BRIEF_REACH = 19   # max |rounded rotated pattern offset| on the canvas


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

    def _entry(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(self.library_path)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._entry()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            rc = fn(*args, ctypes.c_void_p(stream))
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {rc}")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

FAST_SCORE = CudaKernel(
    "fast_score", "pyorbslam_tpu_torch/csrc/fast_score.cu", "fast_score_launch",
    [_P, _P, _I, _I, _P],
    replaces="pyorbslam_tpu/ops/pallas_kernels.py:83",
)
BRIEF_CANVAS = CudaKernel(
    "brief_canvas", "pyorbslam_tpu_torch/csrc/brief_canvas.cu",
    "brief_canvas_launch",
    [_P, _I, _P, _P, _P, _P, _P, _I, _P],
    replaces="pyorbslam_tpu/ops/pallas_kernels.py:327",
)
BRIEF_LEVEL = CudaKernel(
    "brief_level", "pyorbslam_tpu_torch/csrc/brief_level.cu",
    "brief_level_launch",
    [_P, _I, _I, _P, _P, _P, _P, _P, _I, _P],
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
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """FAST-9/16 corner strength of a float32 (H, W) image: the CUDA kernel
    for a CUDA tensor, the twin ``fast.fast_score_map`` for a CPU tensor."""
    if img.device.type == "cpu":
        return fast_ops.fast_score_map(img)
    _check_cuda(img, "img", torch.float32, (None, None), img.device)
    h, w = img.shape
    out = torch.empty_like(img)
    FAST_SCORE.launch(img.device, img.data_ptr(), out.data_ptr(), h, w)
    return out


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
                        cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Launch the brief_canvas kernel on CUDA tensors (no bounds check:
    callers go through :func:`brief_descriptors_canvas`)."""
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
        out.data_ptr(), n)
    return out


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
    blur_canvas: torch.Tensor, xy: torch.Tensor, angle_deg: torch.Tensor
) -> torch.Tensor:
    """Steered rBRIEF on the canvas: the CUDA kernel for CUDA tensors, the
    twin :func:`brief_descriptors_canvas_ref` for CPU tensors.  cos and
    sin are computed here in torch, exactly as the twin computes them."""
    if blur_canvas.device.type == "cpu":
        return brief_descriptors_canvas_ref(blur_canvas, xy, angle_deg)
    _check_brief_bounds(blur_canvas, xy)
    cos, sin = desc_ops.cos_sin(angle_deg)
    return brief_canvas_kernel(blur_canvas, xy, cos.contiguous(), sin.contiguous())


def _check_level_bounds(padded_blurred: torch.Tensor, xy: torch.Tensor) -> None:
    """Raise unless every keypoint lies inside its level: the pad is
    ``BORDER`` = 19 px and the rotated pattern reaches 19, so a keypoint
    anywhere in the level keeps all 512 samples on the padded image.
    (``select_keypoints`` fills invalid slots with in-level pixels too.)"""
    if xy.shape[0] == 0:
        return
    h = padded_blurred.shape[0] - 2 * desc_ops.BORDER
    w = padded_blurred.shape[1] - 2 * desc_ops.BORDER
    out = ((xy < 0).any() | (xy[:, 0] >= w).any() | (xy[:, 1] >= h).any())
    if bool(out):
        raise ValueError(
            f"brief_descriptors_level: a keypoint lies outside the {h}x{w} level")


def brief_level_kernel(padded_blurred: torch.Tensor, xy: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Launch the brief_level kernel on CUDA tensors (no bounds check:
    callers go through :func:`brief_descriptors_level`)."""
    dev = padded_blurred.device
    n = xy.shape[0]
    _check_cuda(padded_blurred, "padded_blurred", torch.float32, (None, None), dev)
    _check_cuda(xy, "xy", torch.int32, (n, 2), dev)
    _check_cuda(cos, "cos", torch.float32, (n,), dev)
    _check_cuda(sin, "sin", torch.float32, (n,), dev)
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    BRIEF_LEVEL.launch(
        dev, padded_blurred.data_ptr(), padded_blurred.shape[1], desc_ops.BORDER,
        xy.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        _pattern_on(dev).data_ptr(), out.data_ptr(), n)
    return out


def brief_descriptors_level(
    padded_blurred: torch.Tensor, xy: torch.Tensor, angle_deg: torch.Tensor
) -> torch.Tensor:
    """Steered rBRIEF on one level: padded_blurred (H + 38, W + 38) float32
    (reflect pad of ``BORDER``), xy (N, 2) int32 level coords, angle (N,)
    degrees -> (N, 8) int32 words.  The CUDA kernel for CUDA tensors, the
    twin ``orb_descriptor.brief_descriptors`` for CPU tensors."""
    if padded_blurred.device.type == "cpu":
        return desc_ops.brief_descriptors(padded_blurred, xy, angle_deg)
    _check_level_bounds(padded_blurred, xy)
    cos, sin = desc_ops.cos_sin(angle_deg)
    return brief_level_kernel(padded_blurred, xy, cos.contiguous(), sin.contiguous())
