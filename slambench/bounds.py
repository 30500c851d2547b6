"""Least device times of the frontend's two hand kernels, from their
shapes: the yardstick of the ``*_roofline`` metrics.

Frozen from ``chip_smoke.py`` (``PEAK_*``, ``FAST_OPS_PER_PIXEL``,
``BRIEF_OPS_PER_KEYPOINT``, ``bound_record``, ``fast_bound``,
``brief_bound`` with its cap of the sampled bytes at the canvas) and from the canvas
arithmetic of ``pyorbslam_tpu_torch/ops/atlas.py::atlas_layout`` at
commit 140fb47.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet): HBM3 rate and the
# float32 rate outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# FAST per pixel: per polarity 32 + 32 two-input minimums and a 15-step
# maximum, the centre subtracted once per polarity, one negation, one
# maximum of the two and one clamp.
FAST_OPS_PER_PIXEL = 2 * (32 + 32 + 15) + 2 + 1 + 2
# rBRIEF per sample: 4 multiplies, 2 adds, 2 roundings and 3 integer ops
# for the address; per pair one comparison.
BRIEF_OPS_PER_KEYPOINT = 512 * 11 + 256
PAD = 19           # each level's reflect border in the canvas


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The larger of bytes over the memory rate and operations over the
    float32 rate, in seconds."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_OPS_PER_S)


def fast_bound_s(pixels: int) -> float:
    """FAST reads the canvas once and writes the score once (float32)."""
    return bound_s(2 * pixels * 4, pixels * FAST_OPS_PER_PIXEL)


def brief_bound_s(keypoints: int, pixels: int) -> float:
    """rBRIEF is a sparse read: per keypoint the 512 samples it needs, but
    no more than the whole image they lie in; per keypoint its
    coordinates, cos and sin, and 8 words out; the 4 KiB pattern once."""
    samples = min(keypoints * 512 * 4, pixels * 4)
    return bound_s(samples + keypoints * (8 + 8 + 32) + 4096,
                   keypoints * BRIEF_OPS_PER_KEYPOINT)


def canvas_shape(height: int, width: int, scale_factor: float, n_levels: int,
                 cell: int) -> tuple:
    """(rows, cols) of the atlas canvas that holds both images' pyramids:
    per level two tiles, each with a 19 px border, row pitch rounded up
    to the FAST cell, the whole rounded up to 8 rows."""
    rows = 0
    for lvl in range(n_levels):
        h = int(round(height * (1.0 / (scale_factor ** lvl))))
        rows += 2 * (-(-(h + 2 * PAD) // cell) * cell)
    return -(-rows // 8) * 8, width + 2 * PAD


def features_per_level_sum(n_features: int, scale_factor: float, n_levels: int) -> int:
    """The keypoint slots of one image (``OrbConfig.features_per_level``)."""
    factor = 1.0 / scale_factor
    n_desired = n_features * (1 - factor) / (1 - factor ** n_levels)
    total = 0
    for _ in range(n_levels - 1):
        n = int(round(n_desired))
        total += n
        n_desired *= factor
    return total + max(n_features - total, 0)
