"""The drive-session generator: a textured corridor world, a route through
it and its stereo frames, all made on the device from ``--seed``.

Frozen from ``pyorbslam_tpu_torch/io/synthetic.py`` (``Plane``,
``corridor_scene``, ``straight_trajectory``, the corridor sizing of
``generate_sequence``) and ``pyorbslam_tpu_torch/io/render_torch.py``
(``TorchRenderer``) at commit 140fb47, with three changes:

* the camera is the settings file's (fx, fy, cx, cy, width, height, and
  the baseline bf / fx), where the port's generator fixes
  ``fx = 0.58 * width``;
* the texture is drawn on the device with a ``torch.Generator`` in a few
  large calls, to the same recipe as ``synthetic._texture`` (two octaves
  of value noise, log-uniform elliptic blobs with a half-weight satellite
  lobe, fine speckle), where the port draws it blob by blob on the host
  (~25 s a 4096-px texture).  Blob sums are accumulated in fixed point,
  so on one kind of device the same seed gives the same texture bit for
  bit, whatever order the atomic adds land in;
* a plane may carry a texture origin (``Plane.tex_origin``, level-0
  texture pixels added to its texture coordinates once the hit test has
  used the unshifted ones), so that each bounded face samples a patch of
  its own; a plane without one renders bit for bit as before.

The route, the scene and the camera are fixed by the traffic file and
the configuration; the seed draws the world's texture.  The straight
corridor is generated here; any other route shape is the file
``routes/<trajectory>.py``, found by the traffic file's ``trajectory``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import List, NamedTuple

import numpy as np
import torch

TEX_SIZE = 4096
FIXED_POINT = float(1 << 20)   # blob sums in units of 2^-20


@dataclasses.dataclass(frozen=True)
class Plane:
    p0: np.ndarray      # a point on the plane (3,)
    n: np.ndarray       # unit normal (3,)
    e1: np.ndarray      # in-plane texture axes (3,)
    e2: np.ndarray
    tex_scale: float    # texture pixels per metre
    ext1: float = np.inf
    ext2: float = np.inf
    # level-0 texture pixels added to the face's (e1, e2) texture
    # coordinates, so bounded faces can sample rectangles of their own
    tex_origin: tuple = (0.0, 0.0)


def corridor_scene(width_m: float = 16.0, ground_y: float = 1.7,
                   tex_px_per_m: float = 48.0) -> List[Plane]:
    """Ground, two side walls and a ceiling (y is down)."""
    def P(p0, n, e1, e2, s):
        return Plane(np.array(p0, np.float64), np.array(n, np.float64),
                     np.array(e1, np.float64), np.array(e2, np.float64), s)
    half = width_m / 2.0
    s = tex_px_per_m
    return [
        P([0, ground_y, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1], s),
        P([-half, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0], s * 0.67),
        P([half, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 1, 0], s * 0.67),
        P([0, -6.0, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1], s * 0.33),
    ]


def straight_trajectory(n_frames: int, speed: float = 1.0,
                        yaw_amp: float = 0.04) -> np.ndarray:
    """Forward motion with gentle sinusoidal yaw -> (N, 4, 4) Twc."""
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    x = z = yaw = 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, 0, 3] = x
        poses[i, 2, 3] = z
        yaw += yaw_amp * np.sin(2 * np.pi * i / max(n_frames, 1))
        x += speed * np.sin(yaw)
        z += speed * np.cos(yaw)
    return poses


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    baseline: float     # metres (bf / fx)

    @property
    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]])


class Route(NamedTuple):
    """One drive session's inputs and the truth about them."""

    left: np.ndarray        # (N, H, W) uint8
    right: np.ndarray
    poses_wc: np.ndarray    # (N, 4, 4) float64 ground-truth Twc, left camera
    timestamps: np.ndarray  # (N,) seconds
    planes: List[Plane]
    camera: Camera


def route_module(trajectory: str):
    """``routes/<trajectory>.py`` as a module: ``poses(traffic, n_frames)``
    and ``scene(traffic, poses)`` of a route shape found by its name."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "routes",
                        trajectory + ".py")
    if not os.path.exists(path):
        raise ValueError(f"trajectory {trajectory!r}: no route file {path}")
    spec = importlib.util.spec_from_file_location(f"slambench_routes_{trajectory}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def route_poses(traffic: dict, n_frames: int) -> np.ndarray:
    if traffic["trajectory"] != "straight":
        return route_module(traffic["trajectory"]).poses(traffic, n_frames)
    return straight_trajectory(n_frames, speed=traffic["speed_m_per_frame"],
                               yaw_amp=traffic["yaw_amp"])


def route_scene(traffic: dict, poses: np.ndarray) -> List[Plane]:
    """``generate_sequence``'s corridor for a straight route: walls wide
    enough to hold the route's lateral wander, texture scale so the
    texture does not repeat over the route and the view ahead.  Any
    other trajectory's scene is its route file's."""
    if traffic["trajectory"] != "straight":
        return route_module(traffic["trajectory"]).scene(traffic, poses)
    if traffic["scene"] != "corridor":
        raise ValueError(f"scene {traffic['scene']!r}: only 'corridor'")
    n = len(poses)
    x_extent = float(np.abs(poses[:, 0, 3]).max())
    width = max(16.0, 2 * x_extent + 10.0)
    length = n * traffic["speed_m_per_frame"] + 60.0
    return corridor_scene(width_m=width, tex_px_per_m=min(48.0, TEX_SIZE / length))


def _value_noise(gen, octave: int, size: int, device) -> torch.Tensor:
    coarse = torch.rand((octave, octave), generator=gen, device=device)
    idx = torch.linspace(0.0, octave - 1.0, size, device=device)
    i0 = torch.floor(idx).long()
    i1 = torch.clamp(i0 + 1, max=octave - 1)
    f = idx - i0
    rows = coarse[i0] * (1 - f)[:, None] + coarse[i1] * f[:, None]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i1] * f[None, :]


def make_texture(seed: int, device, size: int = TEX_SIZE) -> torch.Tensor:
    """A corner-rich aperiodic texture in [30, 230], float32 (size, size)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=device,
                                           dtype=torch.float64)

    tex = 0.35 * _value_noise(gen, 8, size, device) \
        + 0.25 * _value_noise(gen, 32, size, device)
    n = (size // 11) ** 2
    cx, cy = uniform(0, size, n), uniform(0, size, n)
    ra = 2.0 * torch.exp(uniform(0.0, 3.0, n))            # 2..40 px
    rb = ra * uniform(0.4, 1.0, n)
    th = uniform(0.0, np.pi, n)
    sign = torch.where(torch.rand(n, generator=gen, device=device) < 0.5, -1.0, 1.0)
    inten = uniform(0.35, 1.0, n) * sign.double()
    sat = uniform(0.0, 2 * np.pi, n)
    reach = torch.ceil(ra * 1.8).long() + 1                # half-width of the box

    acc = torch.zeros(size * size, dtype=torch.int64, device=device)
    # blobs by size class, so each is drawn in a box near its own size
    for lo, hi in ((0, 8), (8, 16), (16, 32), (32, 80)):
        sel = torch.nonzero((reach > lo) & (reach <= hi)).flatten()
        half = hi
        offs = torch.arange(-half, half + 1, device=device)
        for chunk in torch.split(sel, max(1, (1 << 22) // (2 * half + 1) ** 2)):
            bx = torch.floor(cx[chunk]).long()
            by = torch.floor(cy[chunk]).long()
            xs = bx[:, None, None] + offs[None, None, :]     # (k, 1, S)
            ys = by[:, None, None] + offs[None, :, None]     # (k, S, 1)
            dx = xs.double() - cx[chunk, None, None]
            dy = ys.double() - cy[chunk, None, None]
            c, s = torch.cos(th[chunk])[:, None, None], torch.sin(th[chunk])[:, None, None]
            a, b = ra[chunk, None, None], rb[chunk, None, None]
            u = (c * dx + s * dy) / a
            v = (-s * dx + c * dy) / b
            blob = ((u * u + v * v) <= 1.0).double()
            ox = 1.15 * a * torch.cos(sat[chunk])[:, None, None]
            oy = 1.15 * a * torch.sin(sat[chunk])[:, None, None]
            du = (dx - ox) / (0.45 * a)
            dv = (dy - oy) / (0.45 * a)
            blob = blob + 0.5 * ((du * du + dv * dv) <= 1.0).double()
            r = reach[chunk, None, None]
            inside = ((xs - bx[:, None, None]).abs() <= r) \
                & ((ys - by[:, None, None]).abs() <= r) \
                & (xs >= 0) & (xs < size) & (ys >= 0) & (ys < size) & (blob > 0)
            val = torch.round(0.55 * inten[chunk, None, None] * blob * FIXED_POINT).long()
            idx = (ys * size + xs).expand_as(inside)[inside]
            acc.index_add_(0, idx, val[inside])
    tex = tex + (acc.double() / FIXED_POINT).reshape(size, size).float()
    tex = tex + 0.15 * torch.rand((size, size), generator=gen, device=device)
    tex = tex - tex.min()
    tex = tex / torch.clamp(tex.max(), min=1e-6)
    return (30.0 + 200.0 * tex).to(torch.float32)


def mip_chain(tex: torch.Tensor) -> List[torch.Tensor]:
    """Box-filtered mip chain (``synthetic._mips_for``)."""
    mips = [tex]
    while mips[-1].shape[0] >= 16 and mips[-1].shape[0] % 2 == 0:
        m = mips[-1]
        mips.append((m[0::2, 0::2] + m[1::2, 0::2]
                     + m[0::2, 1::2] + m[1::2, 1::2]) * 0.25)
    return mips


def _dot(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * v, dim=-1)


class Renderer:
    """``render_torch.TorchRenderer``: the scene staged on the device once,
    u8 frames rendered there."""

    def __init__(self, planes: List[Plane], tex: torch.Tensor):
        dev = tex.device
        self.device = dev

        def rows(key):
            return torch.as_tensor(np.stack([getattr(p, key) for p in planes]),
                                   dtype=torch.float32, device=dev)

        def scalars(vals):
            return torch.as_tensor(np.asarray(vals, np.float32), device=dev)

        self.p0, self.nrm, self.e1, self.e2 = (rows(k) for k in ("p0", "n", "e1", "e2"))
        self.scale = scalars([p.tex_scale for p in planes])
        self.ext1 = scalars([min(p.ext1, 1e30) for p in planes])
        self.ext2 = scalars([min(p.ext2, 1e30) for p in planes])
        self.origin = rows("tex_origin")
        mips = mip_chain(tex.to(torch.float32))
        self.n_levels = len(mips)
        self.sizes = torch.as_tensor([m.shape[0] for m in mips], device=dev)
        offs = np.concatenate([[0], np.cumsum([m.numel() for m in mips])])
        self.offsets = torch.as_tensor(offs[:-1], dtype=torch.int64, device=dev)
        self.atlas = torch.cat([m.reshape(-1) for m in mips])

    def render_many(self, Twcs: np.ndarray, cam: Camera, batch: int = 16) -> torch.Tensor:
        """Views of many poses (N, 4, 4) as (N, height, width) uint8 on
        the device, ``batch`` views on a leading axis, so that a scene of
        many planes takes one pass over its planes a batch and not a view.
        A view's pixels do not depend on the batch it is rendered in."""
        return torch.cat([self._render_batch(Twcs[b: b + batch], cam)
                          for b in range(0, len(Twcs), batch)])

    def _render_batch(self, Twcs: np.ndarray, cam: Camera) -> torch.Tensor:
        dev, f32 = self.device, torch.float32
        width, height = cam.width, cam.height
        fx, fy, cx, cy = (float(np.float32(v)) for v in (cam.fx, cam.fy, cam.cx, cam.cy))
        T = torch.as_tensor(np.asarray(Twcs, np.float32), device=dev)       # (B, 4, 4)
        us = torch.arange(width, dtype=f32, device=dev)[None, :]
        vs = torch.arange(height, dtype=f32, device=dev)[:, None]
        dx = ((us - cx) / fx).expand(height, width)[None, ..., None]
        dy = ((vs - cy) / fy).expand(height, width)[None, ..., None]
        Rwc, o = T[:, :3, :3], T[:, :3, 3]
        dirs = dx * Rwc[:, None, None, :, 0] + dy * Rwc[:, None, None, :, 1] \
            + Rwc[:, None, None, :, 2]                                       # (B, H, W, 3)
        dir_n2 = torch.sum(dirs * dirs, dim=-1)
        num = torch.sum((self.p0[None] - o[:, None]) * self.nrm[None], dim=-1)      # (B, P)
        rel0_e1 = torch.sum((o[:, None] - self.p0[None]) * self.e1[None], dim=-1)
        rel0_e2 = torch.sum((o[:, None] - self.p0[None]) * self.e2[None], dim=-1)

        inf = torch.full(dir_n2.shape, float("inf"), dtype=f32, device=dev)
        best_t, tu, tv = inf, torch.zeros_like(inf), torch.zeros_like(inf)
        fp = torch.ones_like(inf)
        for i in range(self.p0.shape[0]):
            denom = _dot(dirs, self.nrm[i])
            t = torch.where(torch.abs(denom) > 1e-9, num[:, i, None, None] / denom, inf)
            valid = (t > 0.05) & (t < 400.0) & (t < best_t)
            tu_m = rel0_e1[:, i, None, None] + t * _dot(dirs, self.e1[i])
            tv_m = rel0_e2[:, i, None, None] + t * _dot(dirs, self.e2[i])
            hit = valid & (torch.abs(tu_m) <= self.ext1[i]) \
                & (torch.abs(tv_m) <= self.ext2[i])
            best_t = torch.where(hit, t, best_t)
            # an origin of 0 changes no sample: x + 0.0 is x, or +0.0 for -0.0,
            # which wraps to the same texel
            tu = torch.where(hit, tu_m * self.scale[i] + self.origin[i, 0], tu)
            tv = torch.where(hit, tv_m * self.scale[i] + self.origin[i, 1], tv)
            fp = torch.where(
                hit, self.scale[i] * t * dir_n2 / (fx * torch.abs(denom) + 1e-9), fp)

        lvl = torch.clamp(torch.log2(torch.clamp(fp, min=1.0)), 0.0, self.n_levels - 1.001)
        l0 = torch.floor(lvl).long()
        fl = lvl - l0
        l1 = torch.clamp(l0 + 1, max=self.n_levels - 1)
        vals = self._sample(l0, tu, tv) * (1 - fl) + self._sample(l1, tu, tv) * fl
        vals = vals / (1.0 + 0.0015 * best_t)
        img = torch.where(torch.isfinite(best_t), vals, torch.full_like(vals, 90.0))
        return (torch.clamp(img, 0, 255) + 0.5).to(torch.uint8)

    def _sample(self, level, u, v):
        size = self.sizes[level]
        off = self.offsets[level]
        s = torch.exp2(-level.to(torch.float32))
        u = u * s
        v = v * s
        sf = size.to(torch.float32)
        u = u - torch.floor(u / sf) * sf
        v = v - torch.floor(v / sf) * sf
        u0f, v0f = torch.floor(u), torch.floor(v)
        fu, fv = u - u0f, v - v0f
        u0 = u0f.long() % size
        v0 = v0f.long() % size
        u1 = (u0 + 1) % size
        v1 = (v0 + 1) % size

        def at(vv, uu):
            return self.atlas[off + vv * size + uu]

        a = at(v0, u0) * (1 - fu) + at(v0, u1) * fu
        b = at(v1, u0) * (1 - fu) + at(v1, u1) * fu
        return a * (1 - fv) + b * fv


def make_route(traffic: dict, camera: Camera, n_frames: int, seed: int,
               device, tex_size: int = TEX_SIZE) -> Route:
    """Render one drive session on ``device``; frames come back to the
    host, where a camera delivers them to the system."""
    poses = route_poses(traffic, n_frames)
    planes = route_scene(traffic, poses)
    renderer = Renderer(planes, make_texture(seed, device, tex_size))
    offset = np.array([camera.baseline, 0.0, 0.0])
    right = poses.copy()
    for Twc in right:       # the right camera: the baseline along the left's x
        Twc[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ offset
    dt = 1.0 / traffic["camera_hz"]
    return Route(left=renderer.render_many(poses, camera).cpu().numpy(),
                 right=renderer.render_many(right, camera).cpu().numpy(), poses_wc=poses,
                 timestamps=np.arange(n_frames, dtype=np.float64) * dt,
                 planes=planes, camera=camera)
