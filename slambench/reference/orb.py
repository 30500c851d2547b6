"""Plain ORB, worked out again at given keypoints of a given image: the
image pyramid, the FAST-9 corner strength, the intensity-centroid
orientation and the steered rBRIEF descriptor, as ORB-SLAM2's
ORBextractor.cpp defines them (ComputePyramid, FAST with its two
thresholds, IC_Angle, computeOrbDescriptor on a 7x7 sigma-2 Gaussian
blur of each level with a 19 px reflected border, rounded to 8 bits).

Plain PyTorch on whatever device the tensors are on.  Imports nothing of
the program; the sampling pattern is OpenCV's 256-pair table
(``orb_brief_pattern.npy`` beside this file).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

BORDER = 19
HALF_PATCH = 15
CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
          (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))
PATTERN = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "orb_brief_pattern.npy")).astype(np.float64)


def level_size(height: int, width: int, scale: float, level: int):
    inv = 1.0 / (scale ** level)
    return int(round(height * inv)), int(round(width * inv))


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with pixel-centre alignment (OpenCV INTER_LINEAR):
    source coordinate (dst + 0.5) * in / out - 0.5, clamped at the edges."""
    in_h, in_w = img.shape
    dev = img.device

    def taps(n_out, n_in):
        s = (torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5) * (n_in / n_out) - 0.5
        i0 = torch.clamp(torch.floor(s), 0, n_in - 1)
        f = torch.clamp(s - i0, 0.0, 1.0)
        i0 = i0.long()
        return i0, torch.clamp(i0 + 1, max=n_in - 1), f

    y0, y1, fy = taps(out_h, in_h)
    x0, x1, fx = taps(out_w, in_w)
    top, bot = img[y0, :], img[y1, :]
    rows = top + fy[:, None] * (bot - top)
    left, right = rows[:, x0], rows[:, x1]
    return left + fx[None, :] * (right - left)


def pyramid(img: torch.Tensor, scale: float, n_levels: int):
    """Each level resized from the one above it (ComputePyramid)."""
    h, w = img.shape
    levels = [img.to(torch.float32)]
    for lvl in range(1, n_levels):
        levels.append(resize_linear(levels[-1], *level_size(h, w, scale, lvl)))
    return levels


def reflect101(img: torch.Tensor, border: int) -> torch.Tensor:
    return F.pad(img[None, None], (border,) * 4, mode="reflect")[0, 0]


def blur_u8(padded: torch.Tensor) -> torch.Tensor:
    """7x7 Gaussian, sigma 2, separable, rounded to integers (the CV_8U
    working image the descriptors sample).  Shifted float32 adds, rows
    then columns: no convolution algorithm of the device's choosing."""
    x = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-(x * x) / 8.0)
    k = [float(v) for v in (k / k.sum()).astype(np.float32)]
    h, w = padded.shape
    img = reflect101(padded, 3)
    rows = sum(k[i] * img[:, i:i + w] for i in range(7))
    return torch.round(sum(k[i] * rows[i:i + h, :] for i in range(7)))


def fast_strength(level: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """FAST-9 corner strength at integer points: the largest t for which
    nine contiguous circle pixels are all brighter than centre + t (or all
    darker than centre - t); 0 if none."""
    c = level[y, x]
    d = torch.stack([level[y + dy, x + dx] - c for dx, dy in CIRCLE], dim=1)
    ring = torch.cat([d, d[:, :8]], dim=1)
    arcs = ring.unfold(1, 9, 1)[:, :16]                     # (N, 16, 9)
    bright = arcs.amin(dim=2).amax(dim=1)
    dark = (-arcs).amin(dim=2).amax(dim=1)
    return torch.clamp(torch.maximum(bright, dark), min=0.0)


def _umax() -> np.ndarray:
    hp = HALF_PATCH
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


def _moment_offsets():
    umax = _umax()
    du, dv = [], []
    for v in range(-HALF_PATCH, HALF_PATCH + 1):
        d = umax[abs(v)]
        for u in range(-d, d + 1):
            du.append(u)
            dv.append(v)
    return np.array(du), np.array(dv)


MOMENT_DU, MOMENT_DV = _moment_offsets()


def ic_angle(padded: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation in degrees [0, 360) over the
    circular 31 px patch of the unblurred bordered level, in float64."""
    dev = padded.device
    du = torch.as_tensor(MOMENT_DU, device=dev)
    dv = torch.as_tensor(MOMENT_DV, device=dev)
    vals = padded[(y[:, None] + BORDER + dv[None, :]),
                  (x[:, None] + BORDER + du[None, :])].double()
    m10 = (vals * du[None, :].double()).sum(dim=1)
    m01 = (vals * dv[None, :].double()).sum(dim=1)
    ang = torch.rad2deg(torch.atan2(m01, m10))
    return torch.where(ang < 0, ang + 360.0, ang)


def rbrief(blurred: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           angle_deg: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF on the blurred bordered level -> (N, 256) bool bits:
    bit k is I(p[2k]) < I(p[2k+1]), each point of the table rotated by the
    keypoint's angle and rounded half to even."""
    dev = blurred.device
    a = torch.deg2rad(angle_deg.to(torch.float32)).double()
    cos, sin = torch.cos(a)[:, None], torch.sin(a)[:, None]
    px = torch.as_tensor(PATTERN[:, 0], device=dev)[None, :]
    py = torch.as_tensor(PATTERN[:, 1], device=dev)[None, :]
    rows = torch.round(px * sin + py * cos).long()
    cols = torch.round(px * cos - py * sin).long()
    vals = blurred[y[:, None] + BORDER + rows, x[:, None] + BORDER + cols]
    return vals[:, 0::2] < vals[:, 1::2]


def words_to_bits(words: np.ndarray) -> np.ndarray:
    """(N, 8) int32 words, pair p at bit p % 32 of word p // 32 -> (N, 256) bool."""
    w = np.ascontiguousarray(words.astype(np.int32)).view(np.uint8)
    return np.unpackbits(w.reshape(len(words), 32), axis=1, bitorder="little").astype(bool)
