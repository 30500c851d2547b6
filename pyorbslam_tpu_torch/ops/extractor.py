"""Per-level ORB extractor: pyramid -> FAST -> spread -> orient -> rBRIEF.

Port of ``pyorbslam_tpu/ops/extractor.py`` (reference:
ORBextractor.cpp operator_kd:1042-1104) as a fixed-shape program: every
level contributes exactly its geometric feature budget worth of
(possibly invalid) slots.  This is the ``OrbConfig.use_atlas=False``
path; the default path is the whole-canvas extraction of
:mod:`pyorbslam_tpu_torch.ops.atlas`.

Per level, the corner scores come from ``kernels.fast_score_map`` and the
descriptors from ``kernels.brief_descriptors_level``: on CUDA tensors the
hand-written ``fast_score`` and ``brief_level`` kernels (16 launches of
each per stereo frame at 8 levels), on CPU tensors their plain twins.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from pyorbslam_tpu_torch.config import OrbConfig
from pyorbslam_tpu_torch.ops import fast as fast_ops
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops

DETECT_BORDER = 16  # EDGE_THRESHOLD - 3: min distance of a corner to the level edge


class FrameFeatures(NamedTuple):
    """SoA keypoint store for one image (fixed capacity, padded)."""

    xy: torch.Tensor        # (N, 2) float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # (N,) float32 FAST corner strength
    angle: torch.Tensor     # (N,) float32 degrees [0, 360)
    octave: torch.Tensor    # (N,) int32 pyramid level
    desc: torch.Tensor      # (N, 8) int32 packed 256-bit rBRIEF
    valid: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def _pad_axis0(arr: torch.Tensor, total: int) -> torch.Tensor:
    pad = total - arr.shape[0]
    if pad <= 0:
        return arr[:total]
    if arr.dtype == torch.bool:
        return F.pad(arr.to(torch.uint8), (0, 0) * (arr.dim() - 1) + (0, pad)).bool()
    return F.pad(arr, (0, 0) * (arr.dim() - 1) + (0, pad))


def extract_features(img: torch.Tensor, orb: OrbConfig,
                     levels=None) -> FrameFeatures:
    """img: float32 (H, W) in [0, 255] -> FrameFeatures with capacity
    ``orb.max_keypoints``.  Pass prebuilt pyramid ``levels`` to share it
    with the stereo SAD atlas."""
    if levels is None:
        levels = pyr_ops.build_pyramid(img, orb.scale_factor, orb.n_levels)
    budgets = orb.features_per_level
    scale_factors = orb.scale_factors

    all_xy, all_resp, all_ang, all_oct, all_desc, all_valid = [], [], [], [], [], []
    for l, level_img in enumerate(levels):
        level_img = level_img.contiguous()
        score = kernels.fast_score_map(level_img)
        score = fast_ops.border_mask(score, DETECT_BORDER)
        score = fast_ops.cell_fallback_mask(
            score, float(orb.ini_th_fast), float(orb.min_th_fast), orb.cell_size
        )
        score = fast_ops.nms3x3(score)
        xy, resp, valid = fast_ops.select_keypoints(
            score, int(budgets[l]), orb.bucket_size, orb.per_bucket_cap
        )
        padded_raw = pyr_ops.reflect_pad(level_img, desc_ops.BORDER)
        m10_map, m01_map = desc_ops.moment_maps(padded_raw)
        ang = desc_ops.ic_angle_from_maps(m10_map, m01_map, xy)
        blurred = pyr_ops.gaussian_blur(level_img)
        padded_blur = pyr_ops.reflect_pad(blurred, desc_ops.BORDER)
        d = kernels.brief_descriptors_level(padded_blur.contiguous(), xy, ang)

        s = torch.tensor(float(scale_factors[l]), dtype=torch.float32,
                         device=img.device)
        all_xy.append(xy.to(torch.float32) * s)
        all_resp.append(resp)
        all_ang.append(ang)
        all_oct.append(torch.full((xy.shape[0],), l, dtype=torch.int32,
                                  device=img.device))
        all_desc.append(d)
        all_valid.append(valid)

    cap = orb.max_keypoints
    return FrameFeatures(
        xy=_pad_axis0(torch.cat(all_xy), cap),
        response=_pad_axis0(torch.cat(all_resp), cap),
        angle=_pad_axis0(torch.cat(all_ang), cap),
        octave=_pad_axis0(torch.cat(all_oct), cap),
        desc=_pad_axis0(torch.cat(all_desc), cap),
        valid=_pad_axis0(torch.cat(all_valid), cap),
    )
