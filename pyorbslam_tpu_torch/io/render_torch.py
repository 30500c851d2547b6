"""Device port of the synthetic-world ray-caster.

Port of ``pyorbslam_tpu/io/render_jax.py``.  The numpy renderer
(``synthetic.render_view``) runs on the host, several seconds a frame for
the large worlds; this module renders the SAME scene description with
tensor ops on the device it is given:

- pass 1: a Python loop over the planes keeps the running nearest hit
  (depth, texture coordinates, pixel footprint) per pixel, an O(H*W)
  carry with no (H, W, n_planes) tensor;
- pass 2: ONE trilinear mip sample for the winning plane per pixel, 8
  gathers into a flattened mip atlas (all mip levels concatenated);
- the u8 quantization on the device (a 4x cheaper read-back).

Pixel-exact parity with the numpy path is not guaranteed (float32 against
float64 ray math; a running minimum against sequential masking resolves
ties alike, but rounding can flip a borderline hit), so a world rendered
here has its own stream-cache key: a world is rendered by one backend
only.  Parity is statistical: almost every pixel within the u8
quantization step (tests/test_torch_render.py).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from pyorbslam_tpu_torch.io.synthetic import Plane, _mips_for


class ScenePack:
    """Scene constants staged once: per-plane geometry rows and the mip
    atlas (every level of the box-filtered chain, flattened)."""

    def __init__(self, planes: List[Plane], tex: np.ndarray):
        self.p0 = np.stack([p.p0 for p in planes]).astype(np.float32)
        self.n = np.stack([p.n for p in planes]).astype(np.float32)
        self.e1 = np.stack([p.e1 for p in planes]).astype(np.float32)
        self.e2 = np.stack([p.e2 for p in planes]).astype(np.float32)
        self.scale = np.asarray([p.tex_scale for p in planes], np.float32)
        # inf extents (unbounded plane) -> huge finite: the inside test
        # then never rejects, matching the numpy branch skip
        self.ext1 = np.asarray([min(p.ext1, 1e30) for p in planes], np.float32)
        self.ext2 = np.asarray([min(p.ext2, 1e30) for p in planes], np.float32)
        self.n_planes = len(planes)

        mips = _mips_for(tex)
        self.n_levels = len(mips)
        self.sizes = np.asarray([m.shape[0] for m in mips], np.int64)
        offs = np.concatenate([[0], np.cumsum([m.size for m in mips])])
        self.offsets = offs[:-1].astype(np.int64)
        self.atlas = np.concatenate([m.astype(np.float32).ravel() for m in mips])


def _dot(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """a (..., 3) . v (3,) as a broadcast multiply-sum (exact float32)."""
    return torch.sum(a * v, dim=-1)


class TorchRenderer:
    """Stages a scene on ``device`` once, renders u8 frames there."""

    def __init__(self, planes: List[Plane], tex: np.ndarray, device):
        self.device = torch.device(device)
        pack = ScenePack(planes, tex)
        self.n_levels = pack.n_levels

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        self.p0, self.nrm, self.e1, self.e2 = (
            dev(a) for a in (pack.p0, pack.n, pack.e1, pack.e2))
        self.scale, self.ext1, self.ext2 = (
            dev(a) for a in (pack.scale, pack.ext1, pack.ext2))
        self.atlas, self.sizes, self.offsets = (
            dev(a) for a in (pack.atlas, pack.sizes, pack.offsets))

    def render_tensor(self, Twc: np.ndarray, K: np.ndarray, width: int,
                      height: int) -> torch.Tensor:
        """One view as an (height, width) uint8 tensor on the device."""
        dev, f32 = self.device, torch.float32
        fx, fy, cx, cy = (float(np.float32(v)) for v in
                          (K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
        T = torch.as_tensor(np.asarray(Twc, np.float32), device=dev)
        us = torch.arange(width, dtype=f32, device=dev)[None, :]
        vs = torch.arange(height, dtype=f32, device=dev)[:, None]
        dx = ((us - cx) / fx).expand(height, width)
        dy = ((vs - cy) / fy).expand(height, width)
        Rwc, o = T[:3, :3], T[:3, 3]
        # dirs = dirs_c @ Rwc^T, dirs_c = (dx, dy, 1)
        dirs = dx[..., None] * Rwc[:, 0] + dy[..., None] * Rwc[:, 1] + Rwc[:, 2]
        dir_n2 = torch.sum(dirs * dirs, dim=-1)

        # per-plane scalars of this view, all planes at once
        num = torch.sum((self.p0 - o) * self.nrm, dim=-1)
        rel0_e1 = torch.sum((o - self.p0) * self.e1, dim=-1)
        rel0_e2 = torch.sum((o - self.p0) * self.e2, dim=-1)

        # ---- pass 1: running nearest hit over the planes ----
        inf = torch.full((height, width), float("inf"), dtype=f32, device=dev)
        best_t, tu, tv = inf, torch.zeros_like(inf), torch.zeros_like(inf)
        fp = torch.ones_like(inf)
        for i in range(self.p0.shape[0]):
            denom = _dot(dirs, self.nrm[i])
            t = torch.where(torch.abs(denom) > 1e-9, num[i] / denom, inf)
            valid = (t > 0.05) & (t < 400.0) & (t < best_t)
            # rel = (o - p0) + t * dirs, projected on the in-plane axes
            tu_m = rel0_e1[i] + t * _dot(dirs, self.e1[i])   # metres along e1
            tv_m = rel0_e2[i] + t * _dot(dirs, self.e2[i])
            hit = valid & (torch.abs(tu_m) <= self.ext1[i]) \
                & (torch.abs(tv_m) <= self.ext2[i])
            best_t = torch.where(hit, t, best_t)
            tu = torch.where(hit, tu_m * self.scale[i], tu)
            tv = torch.where(hit, tv_m * self.scale[i], tv)
            fp = torch.where(
                hit, self.scale[i] * t * dir_n2 / (fx * torch.abs(denom) + 1e-9),
                fp)

        # ---- pass 2: one trilinear mip sample for the winning plane ----
        lvl = torch.clamp(torch.log2(torch.clamp(fp, min=1.0)), 0.0,
                          self.n_levels - 1.001)
        l0 = torch.floor(lvl).long()
        fl = lvl - l0
        l1 = torch.clamp(l0 + 1, max=self.n_levels - 1)
        vals = (self._sample(l0, tu, tv) * (1 - fl)
                + self._sample(l1, tu, tv) * fl)
        vals = vals / (1.0 + 0.0015 * best_t)          # depth cueing
        img = torch.where(torch.isfinite(best_t), vals,
                          torch.full_like(vals, 90.0))
        return (torch.clamp(img, 0, 255) + 0.5).to(torch.uint8)

    def _sample(self, level, u, v):
        """Bilinear sample of mip ``level`` (per pixel) at texel (u, v) of
        level 0, wrapped."""
        size = self.sizes[level]
        off = self.offsets[level]
        s = torch.exp2(-level.to(torch.float32))
        u = u * s
        v = v * s
        sf = size.to(torch.float32)
        u = u - torch.floor(u / sf) * sf               # mod size
        v = v - torch.floor(v / sf) * sf
        u0f = torch.floor(u)
        v0f = torch.floor(v)
        fu = u - u0f
        fv = v - v0f
        u0 = u0f.long() % size
        v0 = v0f.long() % size
        u1 = (u0 + 1) % size
        v1 = (v0 + 1) % size

        def at(vv, uu):
            return self.atlas[off + vv * size + uu]

        a = at(v0, u0) * (1 - fu) + at(v0, u1) * fu
        b = at(v1, u0) * (1 - fu) + at(v1, u1) * fu
        return a * (1 - fv) + b * fv

    def render(self, Twc: np.ndarray, K: np.ndarray, width: int,
               height: int) -> np.ndarray:
        """One view as an (height, width) uint8 host array."""
        return self.render_tensor(Twc, K, width, height).cpu().numpy()
