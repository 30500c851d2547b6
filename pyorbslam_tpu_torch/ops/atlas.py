"""Atlas extraction: the whole ORB frontend as a handful of whole-canvas ops.

Port of ``pyorbslam_tpu/ops/atlas.py``.  Both images' full pyramids (each
level with its own 19 px reflect border, the reference's bordered working
images, ORBextractor.cpp ComputePyramid:1106-1132) are packed into ONE
canvas, and every dense stage runs once over it: FAST score, 16 px
detection-border mask, two-threshold cell fallback (grid-aligned by the
tile pitch and one +shift pad), strict 3x3 NMS, per-bucket cap and
per-tile top-k, IC angles, u8-rounded Gaussian blur and rBRIEF.

The FAST score and the rBRIEF sampling go through
:mod:`pyorbslam_tpu_torch.ops.kernels`: a canvas on a CUDA device runs
the hand-written kernels, a canvas on the CPU runs their plain twins.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pyorbslam_tpu_torch.config import OrbConfig
from pyorbslam_tpu_torch.ops import fast as fast_ops
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as desc_ops
from pyorbslam_tpu_torch.ops import pyramid as pyr_ops
from pyorbslam_tpu_torch.ops.extractor import DETECT_BORDER, FrameFeatures, _pad_axis0
from pyorbslam_tpu_torch.utils.host_read import upload

PAD = desc_ops.BORDER  # 19


class TileSpec(NamedTuple):
    image: int    # 0 = left, 1 = right
    level: int
    row0: int     # tile (padded image) origin in the canvas
    col0: int
    h: int        # level height/width (interior, without the 19px pad)
    w: int


class AtlasLayout(NamedTuple):
    tiles: Tuple[TileSpec, ...]
    canvas_h: int
    canvas_w: int
    shift: int                 # +shift pad aligns cell & bucket grids
    interior16: np.ndarray     # (canvas_h, canvas_w) f32 0/1: >=16px inside
    cand_idx: np.ndarray       # (n_tiles, max_cand) int32 into the flat
    #                            (n_buckets * cap) candidate arrays
    cand_valid: np.ndarray     # (n_tiles, max_cand) bool (rect may overhang)


@functools.lru_cache(maxsize=8)
def atlas_layout(
    height: int, width: int, scale_factor: float, n_levels: int,
    cell: int, bucket: int, cap: int,
) -> AtlasLayout:
    """Static canvas layout for a stereo pair's two pyramids.

    Tiles are stacked vertically, interleaved [L0, R0, L1, R1, ...], each
    at col0=0 with row pitch rounded up to a multiple of ``cell`` (which
    ``bucket`` divides), so one global +shift aligns the canvas cell AND
    bucket grids with every level's own origin-anchored grids.
    """
    if cell % bucket != 0:
        raise ValueError("bucket must divide cell for shared alignment")
    sizes = pyr_ops.level_sizes(height, width, scale_factor, n_levels)
    shift = (-PAD) % cell

    tiles: List[TileSpec] = []
    r = 0
    for l in range(n_levels):
        h, w = sizes[l]
        pitch = -(-(h + 2 * PAD) // cell) * cell
        for img in range(2):
            tiles.append(TileSpec(image=img, level=l, row0=r, col0=0, h=h, w=w))
            r += pitch
    canvas_h = -(-r // 8) * 8
    canvas_w = width + 2 * PAD

    interior16 = np.zeros((canvas_h, canvas_w), np.float32)
    for t in tiles:
        interior16[
            t.row0 + PAD + DETECT_BORDER: t.row0 + PAD + t.h - DETECT_BORDER,
            t.col0 + PAD + DETECT_BORDER: t.col0 + PAD + t.w - DETECT_BORDER,
        ] = 1.0

    # bucket-candidate gather map: bucket (by, bx) of the shifted canvas
    # holds cap candidates at flat slot (by*wb + bx)*cap + j
    wb = -(-(canvas_w + shift) // bucket)
    max_cand = 0
    rects = []
    for t in tiles:
        rb0 = (t.row0 + PAD + DETECT_BORDER + shift) // bucket
        rb1 = -(-(t.row0 + PAD + t.h - DETECT_BORDER + shift) // bucket)
        cb0 = (t.col0 + PAD + DETECT_BORDER + shift) // bucket
        cb1 = -(-(t.col0 + PAD + t.w - DETECT_BORDER + shift) // bucket)
        rects.append((rb0, rb1, cb0, cb1))
        max_cand = max(max_cand, (rb1 - rb0) * (cb1 - cb0) * cap)

    cand_idx = np.zeros((len(tiles), max_cand), np.int32)
    cand_valid = np.zeros((len(tiles), max_cand), bool)
    for ti, (rb0, rb1, cb0, cb1) in enumerate(rects):
        by, bx, j = np.meshgrid(
            np.arange(rb0, rb1), np.arange(cb0, cb1), np.arange(cap),
            indexing="ij",
        )
        flat = ((by * wb + bx) * cap + j).reshape(-1)
        cand_idx[ti, : flat.size] = flat
        cand_valid[ti, : flat.size] = True

    return AtlasLayout(
        tiles=tuple(tiles), canvas_h=canvas_h, canvas_w=canvas_w,
        shift=shift, interior16=interior16,
        cand_idx=cand_idx, cand_valid=cand_valid,
    )


@functools.lru_cache(maxsize=8)
def _layout_tensors(layout_args: tuple, device: torch.device):
    """A layout's static arrays on ``device`` (interior mask, candidate
    index and validity), uploaded once per layout and device through
    pinned memory (no wait for the work queued before)."""
    layout = atlas_layout(*layout_args)
    return (
        upload(layout.interior16, device),
        upload(layout.cand_idx.astype(np.int64), device),
        upload(layout.cand_valid, device),
    )


def assemble_canvas(
    layout: AtlasLayout,
    levels_l: List[torch.Tensor],
    levels_r: List[torch.Tensor],
) -> torch.Tensor:
    """Reflect-pad every level and stack the tiles into the canvas."""
    dev = levels_l[0].device
    bands = []
    r = 0
    per_image = (levels_l, levels_r)
    for t in layout.tiles:
        if t.row0 > r:
            bands.append(torch.zeros((t.row0 - r, layout.canvas_w),
                                     dtype=torch.float32, device=dev))
            r = t.row0
        tile = pyr_ops.reflect_pad(per_image[t.image][t.level], PAD)
        if tile.shape[1] < layout.canvas_w:
            tile = F.pad(tile, (0, layout.canvas_w - tile.shape[1]))
        bands.append(tile)
        r += tile.shape[0]
    if r < layout.canvas_h:
        bands.append(torch.zeros((layout.canvas_h - r, layout.canvas_w),
                                 dtype=torch.float32, device=dev))
    return torch.cat(bands, dim=0)


def _cell_fallback_shifted(
    score: torch.Tensor, ini_th: float, min_th: float, cell: int, shift: int
) -> torch.Tensor:
    """cell_fallback_mask with the grid shifted so canvas cells coincide
    with each level's origin-anchored cells."""
    padded = F.pad(score, (shift, 0, shift, 0))
    out = fast_ops.cell_fallback_mask(padded, ini_th, min_th, cell)
    return out[shift:, shift:]


def _bucket_candidates(
    score: torch.Tensor, bucket: int, cap: int, shift: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bucket top-``cap`` over the shifted canvas.

    Returns (vals (n_buckets*cap,), pix (n_buckets*cap,) int64 flat canvas
    pixel index, -1 where the slot is empty/zero)."""
    h, w = score.shape
    hp, wp = h + shift, w + shift
    hb = -(-hp // bucket)
    wb = -(-wp // bucket)
    padded = F.pad(score, (shift, wb * bucket - wp, shift, hb * bucket - hp))
    blocks = (
        padded.reshape(hb, bucket, wb, bucket)
        .permute(0, 2, 1, 3)
        .reshape(hb * wb, bucket * bucket)
    )
    vals, inner = fast_ops.topk_stable(blocks, cap)          # (B, cap)
    b = torch.arange(hb * wb, device=score.device)
    by = b // wb
    bx = b % wb
    ys = by[:, None] * bucket + inner // bucket - shift
    xs = bx[:, None] * bucket + inner % bucket - shift
    pix = ys * w + xs
    pix = torch.where(vals > 0.0, pix, torch.full_like(pix, -1))
    return vals.reshape(-1), pix.reshape(-1)


class AtlasKeypoints(NamedTuple):
    """The kept keypoints of both images, left image's slots first, and
    the canvases the descriptor stage samples."""

    canvas: torch.Tensor    # (Hc, Wc) float32 atlas canvas
    blur: torch.Tensor      # (Hc, Wc) float32 u8-rounded blurred canvas
    cxy: torch.Tensor       # (K, 2) int32 canvas coords (invalid parked at PAD)
    xy0: torch.Tensor       # (K, 2) float32 level-0 coords
    response: torch.Tensor  # (K,) float32
    octave: torch.Tensor    # (K,) int32
    valid: torch.Tensor     # (K,) bool
    angle: torch.Tensor     # (K,) float32 degrees
    n_half: int             # slots of the left image


def atlas_keypoints(
    left: torch.Tensor, right: torch.Tensor, orb: OrbConfig,
    levels_l: List[torch.Tensor] = None, levels_r: List[torch.Tensor] = None,
) -> AtlasKeypoints:
    """Detection, selection and orientation over the canvas: every stage
    of :func:`extract_features_atlas` before the descriptors."""
    h, w = left.shape
    dev = left.device
    layout_args = (h, w, orb.scale_factor, orb.n_levels,
                   orb.cell_size, orb.bucket_size, orb.per_bucket_cap)
    layout = atlas_layout(*layout_args)
    interior16, cand_idx, cand_valid = _layout_tensors(layout_args, dev)
    if levels_l is None:
        levels_l = pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels)
    if levels_r is None:
        levels_r = pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels)
    canvas = assemble_canvas(layout, levels_l, levels_r)

    # ---- dense stages, one pass each ----
    score = kernels.fast_score_map(canvas)
    score = score * interior16
    score = _cell_fallback_shifted(
        score, float(orb.ini_th_fast), float(orb.min_th_fast),
        orb.cell_size, layout.shift,
    )
    score = fast_ops.nms3x3(score)

    # ---- selection: bucket candidates -> batched per-tile top-k ----
    vals, pix = _bucket_candidates(
        score, orb.bucket_size, orb.per_bucket_cap, layout.shift
    )
    tv = torch.where(cand_valid, vals[cand_idx], torch.zeros((), device=dev))
    tp = torch.where(cand_valid, pix[cand_idx], torch.full((), -1, device=dev))

    budgets = orb.features_per_level
    kmax = int(budgets.max())
    top_v, top_i = fast_ops.topk_stable(tv, kmax)            # (n_tiles, kmax)
    top_p = torch.gather(tp, 1, top_i)
    ys = top_p // layout.canvas_w
    xs = top_p % layout.canvas_w
    valid = (top_v > 0.0) & (top_p >= 0)

    # ---- fold tiles into per-image slots (level-0 coords), so the
    # descriptor stages only touch the kept keypoints ----
    scale_factors = orb.scale_factors
    per_img = {0: [], 1: []}
    for ti, t in enumerate(layout.tiles):
        b = int(budgets[t.level])
        va = valid[ti, :b]
        cx = torch.where(va, xs[ti, :b], PAD)
        cy = torch.where(va, ys[ti, :b], PAD)
        lx = (cx - (t.col0 + PAD)).to(torch.float32)
        ly = (cy - (t.row0 + PAD)).to(torch.float32)
        # a Python scalar holding the float32 value: the same float32
        # multiply as by a 0-dim tensor, with nothing to upload
        s = float(np.float32(scale_factors[t.level]))
        per_img[t.image].append(dict(
            cxy=torch.stack([cx, cy], -1).to(torch.int32),
            xy0=torch.stack([lx * s, ly * s], -1),
            resp=top_v[ti, :b],
            oct=torch.full((b,), t.level, dtype=torch.int32, device=dev),
            va=va,
        ))

    def cat(key):
        return torch.cat(
            [d[key] for d in per_img[0]] + [d[key] for d in per_img[1]], dim=0
        )

    cxy = cat("cxy")          # (2*sum(budgets), 2) canvas coords
    xy0 = cat("xy0")
    resp = cat("resp")
    octv = cat("oct")
    va = cat("va")
    n_half = sum(int(budgets[t.level]) for t in layout.tiles if t.image == 0)

    # ---- orientation on the canvas, one call ----
    blur = torch.round(pyr_ops.gaussian_blur(canvas))  # CV_8U working image
    ang = desc_ops.ic_angles_at(canvas, cxy)
    return AtlasKeypoints(canvas=canvas, blur=blur, cxy=cxy, xy0=xy0,
                          response=resp, octave=octv, valid=va, angle=ang,
                          n_half=n_half)


def extract_features_atlas(
    left: torch.Tensor, right: torch.Tensor, orb: OrbConfig,
    levels_l: List[torch.Tensor] = None, levels_r: List[torch.Tensor] = None,
) -> Tuple[FrameFeatures, FrameFeatures]:
    """Both images' full ORB extraction as whole-canvas ops.

    Returns (left FrameFeatures, right FrameFeatures), each of capacity
    ``orb.max_keypoints``; the tensors live on the images' device.
    """
    kp = atlas_keypoints(left, right, orb, levels_l, levels_r)
    # No bounds check (and so no host read inside the frame's program): a
    # kept keypoint lies where interior16 is set, PAD + DETECT_BORDER px
    # inside its tile, and an empty slot is parked at (PAD, PAD); the
    # pattern reaches PAD px.
    desc = kernels.brief_descriptors_canvas(kp.blur, kp.cxy, kp.angle,
                                            check_bounds=False)

    cap_total = orb.max_keypoints
    xy0, resp, ang, octv, va = kp.xy0, kp.response, kp.angle, kp.octave, kp.valid
    out: List[FrameFeatures] = []
    for sl in (slice(0, kp.n_half), slice(kp.n_half, None)):
        v = va[sl]
        out.append(
            FrameFeatures(
                xy=_pad_axis0(torch.where(v[:, None], xy0[sl], 0.0), cap_total),
                response=_pad_axis0(resp[sl] * v, cap_total),
                angle=_pad_axis0(ang[sl] * v, cap_total),
                octave=_pad_axis0(octv[sl], cap_total),
                desc=_pad_axis0(desc[sl] * v[:, None].to(torch.int32), cap_total),
                valid=_pad_axis0(v, cap_total),
            )
        )
    return out[0], out[1]
