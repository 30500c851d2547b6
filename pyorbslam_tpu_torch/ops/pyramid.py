"""Image pyramid and Gaussian blur.

Port of ``pyorbslam_tpu/ops/pyramid.py``: level sizes are ``round(W /
s^l)`` of the original image, each level bilinearly resized from the
previous one (ORBextractor.cpp ComputePyramid:1106-1132); descriptors are
computed on a 7x7 sigma=2 Gaussian-blurred copy with a reflect-101
border.  The blur keeps the JAX package's seven shifted adds per axis in
the same order, because the atlas rounds the blurred canvas to u8 and a
different summation order would move values across a .5 boundary.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def level_sizes(height: int, width: int, scale_factor: float, n_levels: int
                ) -> List[Tuple[int, int]]:
    """Per-level (H, W): round(dim * invScale^l) of the original image."""
    out = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        out.append((int(round(height * inv)), int(round(width * inv))))
    return out


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with cv2.resize INTER_LINEAR pixel-center
    alignment: src = (dst + 0.5) * scale - 0.5, edge-clamped."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    out_h, out_w = out_hw
    scale_y = in_h / out_h
    scale_x = in_w / out_w
    dev = img.device

    ys = (torch.arange(out_h, dtype=torch.float32, device=dev) + 0.5) * scale_y - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=dev) + 0.5) * scale_x - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, in_h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, in_w - 1)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, max=in_h - 1)
    x1i = torch.clamp(x0i + 1, max=in_w - 1)

    r0 = img[..., y0i, :]
    r1 = img[..., y1i, :]
    rows = r0 + fy[:, None] * (r1 - r0)          # (out_h, in_w)
    c0 = rows[..., :, x0i]
    c1 = rows[..., :, x1i]
    return c0 + fx[None, :] * (c1 - c0)


def build_pyramid(img: torch.Tensor, scale_factor: float, n_levels: int
                  ) -> List[torch.Tensor]:
    """float32 HxW -> list of n_levels float32 images (chained resize)."""
    sizes = level_sizes(img.shape[-2], img.shape[-1], scale_factor, n_levels)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], sizes[l]))
    return levels


def gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def reflect_pad(img: torch.Tensor, border: int) -> torch.Tensor:
    """Reflect-101 border (cv2 BORDER_REFLECT_101, jnp.pad mode="reflect")."""
    return F.pad(img[None, None], (border, border, border, border),
                 mode="reflect")[0, 0]


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0
                  ) -> torch.Tensor:
    """Separable Gaussian blur with reflect-101 border, as shifted adds:
    horizontal pass, then vertical pass, taps in kernel order."""
    k = [float(v) for v in gaussian_kernel_1d(ksize, sigma)]
    half = ksize // 2
    padded = reflect_pad(img, half)
    h, w = img.shape
    acc = torch.zeros((h + 2 * half, w), dtype=img.dtype, device=img.device)
    for i in range(ksize):
        acc = acc + k[i] * padded[:, i:i + w]
    out = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    for i in range(ksize):
        out = out + k[i] * acc[i:i + h, :]
    return out
