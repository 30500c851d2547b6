"""Per-level ORB extractor: pyramid -> FAST -> spread -> orient -> rBRIEF.

Port of ``pyorbslam_tpu/ops/extractor.py`` (reference:
ORBextractor.cpp operator_kd:1042-1104) as a fixed-shape program: every
level contributes exactly its geometric feature budget worth of
(possibly invalid) slots.  This is the ``OrbConfig.use_atlas=False``
path; the default path is the whole-canvas extraction of
:mod:`pyorbslam_tpu_torch.ops.atlas`.

The corner scores of all level images come from one call of
``kernels.fast_score_maps`` and all descriptors from one call of
``kernels.brief_descriptors_levels``: on CUDA tensors one launch each of
the hand-written ``fast_score`` and ``brief_level`` kernels per stereo
frame (:func:`extract_features_stereo`, up to 8 levels), on CPU tensors
their plain twins.  Selection, orientation and blur run per level between
the two.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pyorbslam_tpu_torch.config import OrbConfig
from pyorbslam_tpu_torch.ops import fast as fast_ops
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops
from pyorbslam_tpu_torch.utils.host_read import device_constant

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


def level_keypoints(level_img: torch.Tensor, score: torch.Tensor,
                    orb: OrbConfig, level: int):
    """One level between its FAST score and its descriptors: masks, NMS
    and spread selection, IC angles, and the blurred reflect-padded image
    the descriptors are sampled from.  Returns (xy, response, valid, angle,
    padded_blur)."""
    score = fast_ops.border_mask(score, DETECT_BORDER)
    score = fast_ops.cell_fallback_mask(
        score, float(orb.ini_th_fast), float(orb.min_th_fast), orb.cell_size
    )
    score = fast_ops.nms3x3(score)
    xy, resp, valid = fast_ops.select_keypoints(
        score, int(orb.features_per_level[level]), orb.bucket_size,
        orb.per_bucket_cap
    )
    padded_raw = pyr_ops.reflect_pad(level_img, desc_ops.BORDER)
    m10_map, m01_map = desc_ops.moment_maps(padded_raw)
    ang = desc_ops.ic_angle_from_maps(m10_map, m01_map, xy)
    blurred = pyr_ops.gaussian_blur(level_img)
    padded_blur = pyr_ops.reflect_pad(blurred, desc_ops.BORDER).contiguous()
    return xy, resp, valid, ang, padded_blur


def _extract_pyramids(pyramids, orb: OrbConfig) -> list:
    """FrameFeatures of each pyramid (a list of level images) with one
    FAST call over all level images of all pyramids and one descriptor
    call over all their keypoints."""
    n_levels = len(pyramids[0])
    imgs = [level.contiguous() for levels in pyramids for level in levels]
    scores = kernels.fast_score_maps(imgs)
    per_level = [level_keypoints(img, score, orb, i % n_levels)
                 for i, (img, score) in enumerate(zip(imgs, scores))]
    # no bounds check: select_keypoints keeps every slot, padding
    # included, inside its level (the check would read back a flag and
    # wait for the whole frame queued before it)
    desc = kernels.brief_descriptors_levels(
        [p[4] for p in per_level], [p[0] for p in per_level],
        [p[3] for p in per_level], check_bounds=False)

    device = imgs[0].device
    cap = orb.max_keypoints
    scales = device_constant(np.asarray(orb.scale_factors, np.float32),
                             torch.float32, device)
    out, first = [], 0
    for b in range(len(pyramids)):
        mine = per_level[b * n_levels: (b + 1) * n_levels]
        n = sum(p[0].shape[0] for p in mine)
        out.append(FrameFeatures(
            xy=_pad_axis0(torch.cat([p[0].to(torch.float32) * scales[l]
                                     for l, p in enumerate(mine)]), cap),
            response=_pad_axis0(torch.cat([p[1] for p in mine]), cap),
            angle=_pad_axis0(torch.cat([p[3] for p in mine]), cap),
            octave=_pad_axis0(torch.cat([
                torch.full((p[0].shape[0],), l, dtype=torch.int32, device=device)
                for l, p in enumerate(mine)]), cap),
            desc=_pad_axis0(desc[first: first + n], cap),
            valid=_pad_axis0(torch.cat([p[2] for p in mine]), cap),
        ))
        first += n
    return out


def extract_features(img: torch.Tensor, orb: OrbConfig,
                     levels=None) -> FrameFeatures:
    """img: float32 (H, W) in [0, 255] -> FrameFeatures with capacity
    ``orb.max_keypoints``.  Pass prebuilt pyramid ``levels`` to share it
    with the stereo SAD atlas."""
    if levels is None:
        levels = pyr_ops.build_pyramid(img, orb.scale_factor, orb.n_levels)
    return _extract_pyramids([levels], orb)[0]


def extract_features_stereo(left: torch.Tensor, right: torch.Tensor,
                            orb: OrbConfig, levels_l=None, levels_r=None):
    """:func:`extract_features` of both images of a stereo pair, with the
    FAST scores of all their level images in one call and all their
    descriptors in one call (on CUDA tensors: one ``fast_score`` and one
    ``brief_level`` launch a frame).  Returns (left, right) FrameFeatures,
    each equal to what :func:`extract_features` gives for its image.  More
    than 8 levels do not fit one launch's image table; each image then
    takes its own calls."""
    if levels_l is None:
        levels_l = pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels)
    if levels_r is None:
        levels_r = pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels)
    if len(levels_l) + len(levels_r) > kernels.MAX_IMAGES:
        return (_extract_pyramids([levels_l], orb)[0],
                _extract_pyramids([levels_r], orb)[0])
    lf, rf = _extract_pyramids([levels_l, levels_r], orb)
    return lf, rf
