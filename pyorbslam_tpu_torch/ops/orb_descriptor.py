"""Keypoint orientation (intensity centroid) and rotated-BRIEF descriptors.

Port of ``pyorbslam_tpu/ops/orb_descriptor.py`` (reference:
ORBextractor.cpp IC_Angle:77-104 and computeOrbDescriptor:108-147).
Descriptors are packed little-endian into 8 words per keypoint: pair
``p`` lands in word ``p // 32`` at bit ``p % 32``.  The JAX package holds
the words as uint32; this package holds them as int32 with the same bits,
because PyTorch's uint32 support (shifts, sums) is partial on CUDA.

The 512-point sampling pattern is read by file path from the JAX
package's asset ``pyorbslam_tpu/assets/orb_brief_pattern.npy`` (the
standard OpenCV rBRIEF table), without importing that package.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from pyorbslam_tpu_torch.utils.host_read import device_constant

HALF_PATCH_SIZE = 15
PATCH_SIZE = 31
BORDER = 19  # reflected border budget around each level (EDGE_THRESHOLD)

PATTERN_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "pyorbslam_tpu", "assets", "orb_brief_pattern.npy",
)


@lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(512, 2) int32 (x, y) sampling offsets."""
    return np.load(PATTERN_PATH)


@lru_cache(maxsize=1)
def umax_table() -> np.ndarray:
    """Circular-patch row extents, symmetric (ORBextractor.cpp:454-469)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 1, dtype=np.int64)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool/0-1 -> (..., 8) int32 words, bit j of word w =
    bits[32w + j] (the bit pattern of the JAX package's uint32 words)."""
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (-1, 32))
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    return to_int32_bits((b << shifts).sum(dim=-1))


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same low 32 bits."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def rotated_offsets(angle_deg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotated, rounded pattern offsets (rows, cols), each (N, 512) int64:
    row = round(px*sin + py*cos), col = round(px*cos - py*sin), rounding
    half to even (the reference's cvRound'd GET_VALUE)."""
    a, b = cos_sin(angle_deg)
    return rotated_offsets_cs(a, b)


def cos_sin(angle_deg: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 cos and sin of an angle in degrees (jnp.radians semantics:
    one multiply by float32 pi/180)."""
    # a Python scalar holding the float32 value: the product is the same
    # float32 multiply, with nothing to upload
    rad = angle_deg * float(np.float32(np.pi / 180.0))
    return torch.cos(rad), torch.sin(rad)


def rotated_offsets_cs(a: torch.Tensor, b: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    pat = device_constant(brief_pattern(), torch.float32, a.device)
    px, py = pat[None, :, 0], pat[None, :, 1]
    a = a[:, None]
    b = b[:, None]
    rows = torch.round(px * b + py * a).long()
    cols = torch.round(px * a - py * b).long()
    return rows, cols


def gather_patches(
    padded: torch.Tensor, xy: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
    border: int = BORDER,
) -> torch.Tensor:
    """Gather per-keypoint samples from a reflect-padded level image.

    padded: (H + 2*border, W + 2*border); xy: (N, 2) int level coords;
    dy/dx: (P,) or (N, P) int offsets.  Returns (N, P) float32.
    """
    wp = padded.shape[-1]
    xy = xy.long()
    ys = xy[:, 1:2] + border + (dy if dy.dim() == 2 else dy[None, :])
    xs = xy[:, 0:1] + border + (dx if dx.dim() == 2 else dx[None, :])
    flat_idx = ys * wp + xs
    return padded.reshape(-1)[flat_idx]


def _angle_deg(m01: torch.Tensor, m10: torch.Tensor) -> torch.Tensor:
    ang = torch.atan2(m01, m10) * float(np.float32(180.0 / np.pi))
    return torch.where(ang < 0, ang + 360.0, ang)


def _moment_weights() -> Tuple[np.ndarray, np.ndarray]:
    """(961,) weights: m10 = patch . wx and m01 = patch . wy over the
    circular patch."""
    umax = umax_table()
    hp = HALF_PATCH_SIZE
    wx = np.zeros((PATCH_SIZE, PATCH_SIZE), np.float32)
    wy = np.zeros((PATCH_SIZE, PATCH_SIZE), np.float32)
    for dv in range(-hp, hp + 1):
        d = umax[abs(dv)]
        for du in range(-d, d + 1):
            wx[dv + hp, du + hp] = du
            wy[dv + hp, du + hp] = dv
    return wx.reshape(-1), wy.reshape(-1)


def ic_angle(padded_level: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation in degrees [0, 360), the reference
    formulation (IC_Angle, ORBextractor.cpp:77-104): a 31x31 patch gathered
    per keypoint from the *unblurred* reflect-padded level, dotted with the
    moment weights.  Kept for golden tests; the extractor uses
    :func:`ic_angles_at` (the same sums without per-keypoint patches)."""
    hp = HALF_PATCH_SIZE
    dev = padded_level.device
    offs = np.arange(-hp, hp + 1)
    dyg, dxg = np.meshgrid(offs, offs, indexing="ij")
    patches = gather_patches(
        padded_level, xy, torch.as_tensor(dyg.reshape(-1), device=dev),
        torch.as_tensor(dxg.reshape(-1), device=dev))       # (N, 961)
    wx, wy = (torch.as_tensor(w, device=dev) for w in _moment_weights())
    return _angle_deg(torch.sum(patches * wy, dim=1),
                      torch.sum(patches * wx, dim=1))


def moment_maps(padded_level: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-image intensity-centroid moment maps (m10, m01) of a
    (H + 2*BORDER, W + 2*BORDER) padded level, from row cumulative sums:
    each patch row dy contributes the interval |dx| <= umax(dy).  Valid
    wherever the full patch fits."""
    hp = HALF_PATCH_SIZE
    umax = umax_table()
    hpd, wpd = padded_level.shape
    dev = padded_level.device
    I = padded_level
    cols = torch.arange(wpd, dtype=torch.float32, device=dev)[None, :]
    zcol = torch.zeros((hpd, 1), dtype=I.dtype, device=dev)
    cumI = torch.cat([zcol, torch.cumsum(I, dim=1)], dim=1)
    cumJ = torch.cat([zcol, torch.cumsum(cols * I, dim=1)], dim=1)

    m10 = torch.zeros_like(I)
    m01 = torch.zeros_like(I)
    hi_rows = hpd - 2 * hp
    wi = wpd - 2 * hp
    xin = cols[:, hp:wpd - hp]
    for dy in range(-hp, hp + 1):
        d = int(umax[abs(dy)])
        rowI = cumI[hp + dy: hp + dy + hi_rows]
        rowJ = cumJ[hp + dy: hp + dy + hi_rows]
        wI = rowI[:, hp + d + 1: hp + d + 1 + wi] - rowI[:, hp - d: hp - d + wi]
        wJ = rowJ[:, hp + d + 1: hp + d + 1 + wi] - rowJ[:, hp - d: hp - d + wi]
        m10[hp:hpd - hp, hp:wpd - hp] += wJ - xin * wI
        m01[hp:hpd - hp, hp:wpd - hp] += float(dy) * wI
    return m10, m01


def ic_angles_at(padded: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """IC orientation (degrees, [0, 360)) evaluated at keypoints only: row
    cumulative sums and four gathers per (keypoint, patch row).  Column
    weights are centred mid-canvas so cumsum(col*I) stays small at wide
    canvases; the centring is compensated exactly in m10."""
    hp = HALF_PATCH_SIZE
    umax = umax_table()
    hpd, wpd = padded.shape
    dev = padded.device
    c0 = float(wpd // 2)
    cols = (torch.arange(wpd, dtype=torch.float32, device=dev) - c0)[None, :]
    zcol = torch.zeros((hpd, 1), dtype=padded.dtype, device=dev)
    cumI = torch.cat([zcol, torch.cumsum(padded, dim=1)], dim=1)
    cumJ = torch.cat([zcol, torch.cumsum(cols * padded, dim=1)], dim=1)
    W1 = wpd + 1
    x = xy[:, 0].long()
    y = xy[:, 1].long()
    dys = torch.arange(-hp, hp + 1, dtype=torch.int64, device=dev)
    ds = device_constant(umax[np.abs(np.arange(-hp, hp + 1))], torch.int64, dev)
    rows = (y[:, None] + dys[None, :]) * W1                   # (N, 31)
    hi = rows + x[:, None] + ds[None, :] + 1
    lo = rows + x[:, None] - ds[None, :]
    cI = cumI.reshape(-1)
    cJ = cumJ.reshape(-1)
    winI = cI[hi] - cI[lo]
    winJ = cJ[hi] - cJ[lo]
    m10 = torch.sum(winJ, dim=1) - (x.to(torch.float32) - c0) * torch.sum(
        winI, dim=1)
    m01 = torch.sum(winI * dys[None, :].to(torch.float32), dim=1)
    return _angle_deg(m01, m10)


def ic_angle_from_maps(
    m10_map: torch.Tensor, m01_map: torch.Tensor, xy: torch.Tensor,
    border: int = BORDER,
) -> torch.Tensor:
    """Orientation lookup: two gathers per keypoint."""
    wp = m10_map.shape[-1]
    xy = xy.long()
    idx = (xy[:, 1] + border) * wp + (xy[:, 0] + border)
    m10 = m10_map.reshape(-1)[idx]
    m01 = m01_map.reshape(-1)[idx]
    return _angle_deg(m01, m10)


def brief_descriptors(
    padded_blurred: torch.Tensor, xy: torch.Tensor, angle_deg: torch.Tensor
) -> torch.Tensor:
    """Steered 256-bit BRIEF on a reflect-padded blurred level -> (N, 8)
    int32 words.  Plain twin of the ``brief_level`` CUDA kernel
    (``csrc/brief_level.cu``, the port of the JAX package's
    ``brief_descriptors_pallas``); the per-level extractor reaches it
    through ``kernels.brief_descriptors_level`` on CPU tensors."""
    rows, cols = rotated_offsets(angle_deg)
    vals = gather_patches(padded_blurred, xy, rows, cols)  # (N, 512)
    return pack_bits(vals[:, 0::2] < vals[:, 1::2])
