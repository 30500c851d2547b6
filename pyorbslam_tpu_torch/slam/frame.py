"""Per-frame perception: stereo ORB extraction and stereo matching.

Port of ``pyorbslam_tpu/slam/frame.py`` (reference: Frame.py:13-73).
One call builds a fixed-shape SoA :class:`StereoFrame` on the images'
device.  The reference's 64x48 feature grid exists only to make CPU
radius queries O(1); the projection matchers compute full candidate
masks instead, so no grid is built.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pyorbslam_tpu_torch.config import SlamConfig
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops
from pyorbslam_tpu_torch.ops import stereo as stereo_ops
from pyorbslam_tpu_torch.ops.atlas import extract_features_atlas
from pyorbslam_tpu_torch.ops.extractor import extract_features_stereo
from pyorbslam_tpu_torch.ops.hamming import unpack_bits
from pyorbslam_tpu_torch.utils import trace
from pyorbslam_tpu_torch.utils.host_read import device_constant


class StereoFrame(NamedTuple):
    """Device-side SoA for one tracked stereo frame (capacity N)."""

    xy: torch.Tensor        # (N, 2) float32 level-0 keypoint coords (left)
    response: torch.Tensor  # (N,)
    angle: torch.Tensor     # (N,) degrees
    octave: torch.Tensor    # (N,) int32
    desc: torch.Tensor      # (N, 8) int32 (the JAX package's uint32 bits)
    desc_bits: torch.Tensor # (N, 256) int8 unpacked
    valid: torch.Tensor     # (N,) bool
    u_right: torch.Tensor   # (N,) float32, -1 if no stereo match
    depth: torch.Tensor     # (N,) float32, -1 if no stereo match

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


@trace.spanned("track.frontend")
def build_stereo_frame(
    left: torch.Tensor, right: torch.Tensor, cfg: SlamConfig
) -> StereoFrame:
    """left/right: (H, W) images (u8 or float32 in [0, 255]) on the device
    that runs the frame."""
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    orb = cfg.orb
    # each pyramid is built once and shared by extraction and the SAD atlas
    levels_l = pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels)
    levels_r = pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels)
    if orb.use_atlas:
        lf, rf = extract_features_atlas(
            left, right, orb, levels_l=levels_l, levels_r=levels_r
        )
    else:
        lf, rf = extract_features_stereo(
            left, right, orb, levels_l=levels_l, levels_r=levels_r
        )

    atlas_l = stereo_ops.build_atlas(levels_l)
    atlas_r = stereo_ops.build_atlas(levels_r)
    scale_factors = device_constant(orb.scale_factors, torch.float32,
                                    left.device)
    u_right, depth = stereo_ops.match_stereo(
        lf.xy, lf.octave, lf.desc, lf.valid,
        rf.xy, rf.octave, rf.desc, rf.valid,
        atlas_l, atlas_r, scale_factors,
        bf=cfg.camera.bf,
        max_disparity=cfg.camera.fx,
        th_orb=(cfg.tracking.th_high + cfg.tracking.th_low) / 2.0,
    )
    return StereoFrame(
        xy=lf.xy, response=lf.response, angle=lf.angle, octave=lf.octave,
        desc=lf.desc, desc_bits=unpack_bits(lf.desc), valid=lf.valid,
        u_right=u_right, depth=depth,
    )


def pack_frame(frame: StereoFrame) -> torch.Tensor:
    """Every per-feature field the host consumes, in ONE int32 buffer:
    [xy bits 2N | angle N | u_right N | depth N | response N | octave N |
    valid N | desc 8N]."""
    def b(a):
        return a.contiguous().view(torch.int32).reshape(-1)

    return torch.cat([
        b(frame.xy), b(frame.angle), b(frame.u_right), b(frame.depth),
        b(frame.response), frame.octave.to(torch.int32),
        frame.valid.to(torch.int32), frame.desc.reshape(-1),
    ])


def unpack_frame_np(packed: np.ndarray, n: int) -> dict:
    """Host-side inverse of :func:`pack_frame` (numpy views, no copies
    except octave/valid); desc stays int32, as in the port."""
    def f(a):
        return a.view(np.float32)

    return dict(
        xy=f(packed[: 2 * n]).reshape(n, 2),
        angle=f(packed[2 * n: 3 * n]),
        u_right=f(packed[3 * n: 4 * n]),
        depth=f(packed[4 * n: 5 * n]),
        response=f(packed[5 * n: 6 * n]),
        octave=packed[6 * n: 7 * n].copy(),
        valid=packed[7 * n: 8 * n].astype(bool),
        desc=packed[8 * n: 16 * n].reshape(n, 8),
    )


def unproject(frame: StereoFrame, cfg: SlamConfig, Twc: torch.Tensor) -> torch.Tensor:
    """Back-project all stereo-matched keypoints to world coords
    (Frame.unproject_stereo, Frame.py:281-291).  Returns (N, 3); rows
    with depth <= 0 are garbage, mask with frame.depth > 0."""
    cam = cfg.camera
    z = frame.depth
    x = (frame.xy[:, 0] - cam.cx) * z / cam.fx
    y = (frame.xy[:, 1] - cam.cy) * z / cam.fy
    pc = torch.stack([x, y, z], dim=-1)
    return pc @ Twc[:3, :3].T + Twc[:3, 3]
