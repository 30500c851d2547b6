"""Per-frame perception: stereo ORB extraction and stereo matching.

Port of ``pyorbslam_tpu/slam/frame.py`` (reference: Frame.py:13-73).
One call builds a fixed-shape SoA :class:`StereoFrame` on the images'
device.  The reference's 64x48 feature grid exists only to make CPU
radius queries O(1); the projection matchers compute full candidate
masks instead, so no grid is built.

The body (:func:`stereo_frame_body`) is ~1,150 small launches a frame at
2000 features, so on a CUDA device :func:`build_stereo_frame` replays it
as one CUDA graph: the body runs eagerly on the first call of each
:func:`graph_key`, is then captured, and later calls copy their images
into the graph's inputs, replay it and clone its outputs.  The same
kernels run with the same launch parameters, so a replay is bit-equal to
the eager body.  CPU tensors always take the eager body.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from pyorbslam_tpu_torch.config import SlamConfig
from pyorbslam_tpu_torch.ops import kernels
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


def build_stereo_frame(
    left: torch.Tensor, right: torch.Tensor, cfg: SlamConfig
) -> StereoFrame:
    """left/right: (H, W) images (u8 or float32 in [0, 255]) on the device
    that runs the frame.  A ``track.frontend`` span whose ``graph`` is 1
    when the call replayed a captured graph, 0 when it ran the body."""
    with trace.span("track.frontend") as sp:
        key = graph_key(left, right, cfg) if left.device.type == "cuda" else None
        graph = _GRAPHS.get(key)
        if graph is None:
            frame = stereo_frame_body(left, right, cfg)
            if key is not None:
                _GRAPHS[key] = FrontendGraph(left, right, cfg)
        else:
            frame = graph(left, right)
        if sp is not None:
            sp.args["graph"] = int(graph is not None)
    return frame


def graph_key(left: torch.Tensor, right: torch.Tensor, cfg: SlamConfig) -> tuple:
    """What one captured frontend is made for: the device, both images'
    shape and dtype, and every setting :func:`stereo_frame_body` reads
    (all of ``cfg.orb``, ``bf`` and ``fx``, the two descriptor
    thresholds)."""
    return (left.device, left.shape, left.dtype, right.shape, right.dtype,
            cfg.orb, cfg.camera.bf, cfg.camera.fx,
            cfg.tracking.th_high, cfg.tracking.th_low)


class FrontendGraph:
    """:func:`stereo_frame_body` captured as one CUDA graph in its own
    memory pool: the static images it reads, the :class:`StereoFrame` it
    writes, and the hand-written kernel launches it holds.  Every tensor
    it reads outside its pool (the images, the cached device constants)
    lives as long as the process.

    Capture after an eager call of the body on the same key, which fills
    the device constants and the allocator; a ``track.frontend_capture``
    span with the images' size."""

    def __init__(self, left: torch.Tensor, right: torch.Tensor, cfg: SlamConfig):
        with trace.span("track.frontend_capture") as sp, \
                torch.cuda.device(left.device):
            if sp is not None:
                sp.args.update(height=left.shape[0], width=left.shape[1])
            self.left = torch.empty(left.shape, dtype=left.dtype, device=left.device)
            self.right = torch.empty(right.shape, dtype=right.dtype, device=right.device)
            self.graph = torch.cuda.CUDAGraph()
            before = kernels.launch_counts()
            # thread_local: another thread (the live viewer's) may call CUDA
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self.out = stereo_frame_body(self.left, self.right, cfg)
            self.launches = kernels.take_captured(before)

    def __call__(self, left: torch.Tensor, right: torch.Tensor) -> StereoFrame:
        """Replay on the images, on the current stream.  The outputs are
        fresh tensors: callers keep frames across later replays."""
        with torch.cuda.device(self.left.device):
            self.left.copy_(left)
            self.right.copy_(right)
            self.graph.replay()
            kernels.count_launches(self.launches)
            return StereoFrame(*(t.clone() for t in self.out))


# every captured frontend of the process, by graph_key
_GRAPHS: Dict[tuple, FrontendGraph] = {}


def stereo_frame_body(
    left: torch.Tensor, right: torch.Tensor, cfg: SlamConfig
) -> StereoFrame:
    """The frontend as eager launches: pyramids, ORB extraction of both
    images, stereo matching.  No host read and no upload, so a CUDA graph
    can capture it."""
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
