"""Synthetic textured stereo-world generator.

A copy of ``pyorbslam_tpu/io/synthetic.py`` whose device renderer branch
is ``io/render_torch.py`` (``SyntheticStream(render_backend="torch")``)
in place of the JAX one, so the port renders its own frames where JAX is
absent.  The same arguments give the same images as the JAX package's
numpy renderer.

The reference validates end-to-end against KITTI sequences
(stereo_kitti.py); no KITTI data ships with the repository, so integration
tests and benchmarks render a deterministic synthetic "corridor" world —
textured ground + side walls — from known camera trajectories.  The
renderer produces imagery with dense FAST-detectable corners and exact
ground-truth poses, which is what the accuracy gates actually need.

Conventions match the tracker: camera frame is x-right / y-down /
z-forward; the world frame equals the first left-camera frame; poses are
``Twc`` (camera -> world).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
from typing import List, Optional

import numpy as np


def _bilinear_noise(rng, octave: int, size: int) -> np.ndarray:
    """Smooth value noise: bilinear upsample of a random octave grid."""
    coarse = rng.random((octave, octave)).astype(np.float32)
    idx = np.linspace(0.0, octave - 1.0, size).astype(np.float32)
    i0 = np.floor(idx).astype(np.int64)
    i1 = np.minimum(i0 + 1, octave - 1)
    f = idx - i0
    rows = coarse[i0] * (1 - f)[:, None] + coarse[i1] * f[:, None]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i1] * f[None, :]


def make_texture(size: int = 1024, seed: int = 0) -> np.ndarray:
    """Procedural corner-rich APERIODIC texture in [0, 255] float32 (a
    fresh copy of the process's memo: a 4096-px texture takes ~25 s to
    draw on a CPU core)."""
    return _texture(size, seed).copy()


@functools.lru_cache(maxsize=2)
def _texture(size: int, seed: int) -> np.ndarray:
    """The texture of :func:`make_texture`.

    Scattered hard-edged ellipse blobs with random position, size, aspect,
    orientation and intensity over smooth value noise.  An earlier version
    placed identical-amplitude blobs on a regular kron lattice; that gave
    the texture a 1.3-2.7 m repeat period on world surfaces, and any
    tracking chain that drifted about one lattice cell could lock onto the
    shifted copy with high inlier consensus (exactly the false-alias
    failure the round-4 interior world fixed for *structure*).  Scattered
    blobs have no repeat period at any scale.
    """
    rng = np.random.default_rng(seed)
    # smooth low-frequency illumination variation (not corner-forming)
    tex = 0.35 * _bilinear_noise(rng, 8, size) \
        + 0.25 * _bilinear_noise(rng, 32, size)
    # Scattered blobs with a LOG-UNIFORM radius distribution (2-40 px)
    # and an attached half-intensity satellite lobe.  Equal-size sharp
    # blobs made every corner fire at every pyramid level (the same
    # physical corner re-detected at a different octave each frame,
    # 47% octave churn) and near-symmetric mass left the IC orientation
    # ill-defined (p90 angle churn ~60 deg) — scale-localized detail
    # plus an asymmetric lobe pins both, like real-world texture does.
    n_blobs = (size // 11) ** 2
    cx = rng.uniform(0, size, n_blobs)
    cy = rng.uniform(0, size, n_blobs)
    ra = 2.0 * np.exp(rng.uniform(0.0, 3.0, n_blobs))     # 2..40 px
    rb = ra * rng.uniform(0.4, 1.0, n_blobs)
    th = rng.uniform(0, np.pi, n_blobs)
    inten = rng.uniform(0.35, 1.0, n_blobs) * rng.choice(
        [-1.0, 1.0], n_blobs)
    # satellite lobe: offset along the major axis, smaller + weaker
    sat_phase = rng.uniform(0, 2 * np.pi, n_blobs)
    for k in range(n_blobs):
        r = int(np.ceil(ra[k] * 1.8)) + 1
        xs = np.arange(max(int(cx[k]) - r, 0), min(int(cx[k]) + r + 1, size))
        ys = np.arange(max(int(cy[k]) - r, 0), min(int(cy[k]) + r + 1, size))
        if len(xs) == 0 or len(ys) == 0:
            continue
        dx = xs[None, :] - cx[k]
        dy = ys[:, None] - cy[k]
        c, s = np.cos(th[k]), np.sin(th[k])
        u = (c * dx + s * dy) / ra[k]
        v = (-s * dx + c * dy) / rb[k]
        blob = ((u * u + v * v) <= 1.0).astype(np.float32)
        # satellite: radius 0.45r at distance 1.15r, direction sat_phase
        ox = 1.15 * ra[k] * np.cos(sat_phase[k])
        oy = 1.15 * ra[k] * np.sin(sat_phase[k])
        du = (dx - ox) / (0.45 * ra[k])
        dv = (dy - oy) / (0.45 * ra[k])
        blob += 0.5 * ((du * du + dv * dv) <= 1.0)
        tex[ys[0]: ys[-1] + 1, xs[0]: xs[-1] + 1] += \
            (0.55 * inten[k]) * blob
    # fine speckle so every 31x31 patch has gradient
    tex += 0.15 * rng.random((size, size)).astype(np.float32)
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return (30.0 + 200.0 * tex).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Plane:
    p0: np.ndarray      # a point on the plane (3,)
    n: np.ndarray       # unit normal (3,)
    e1: np.ndarray      # in-plane texture axes (3,)
    e2: np.ndarray
    tex_scale: float    # texture pixels per meter
    ext1: float = np.inf   # half-extent along e1 (meters; inf = infinite)
    ext2: float = np.inf   # half-extent along e2


def corridor_scene(width_m: float = 16.0, ground_y: float = 1.7,
                   tex_px_per_m: float = 48.0) -> List[Plane]:
    """Texture scales must keep the tile period (tex_size / px_per_m)
    larger than the revisit geometry, or place recognition sees *genuine*
    visual aliasing (the texture tiles) and closes false loops."""
    def P(p0, n, e1, e2, s):
        return Plane(np.array(p0, np.float64), np.array(n, np.float64),
                     np.array(e1, np.float64), np.array(e2, np.float64), s)
    half = width_m / 2.0
    s = tex_px_per_m
    return [
        P([0, ground_y, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1], s),        # ground
        P([-half, 0, 0], [1, 0, 0], [0, 0, 1], [0, 1, 0], s * 0.67),     # left wall
        P([half, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 1, 0], s * 0.67),     # right wall
        P([0, -6.0, 0], [0, 1, 0], [1, 0, 0], [0, 0, 1], s * 0.33),      # ceiling
    ]


# bump when any scene/render code changes — keys the per-frame cache
_SCENE_VERSION = "v5"


def interior_loop_scene(radius: float, ground_y: float = 1.7,
                        tex_px_per_m: float = 48.0,
                        n_pillars: int = 16, pillar_side: float = 2.0,
                        ring_offsets=(-9.0, 11.0),
                        seed: int = 0) -> List[Plane]:
    """A loop-course world whose structure stays INSIDE the stereo depth
    gate everywhere on the path: textured ground plus two rings of square
    pillars flanking the circular trajectory (center (0, radius) in
    x-z).  Unlike :func:`corridor_scene` at large radii — whose walls sit
    beyond the ~40 m stereo range, leaving odometry depth-poor — every
    viewpoint here sees close structure, so tracking stays
    well-conditioned while yaw drift still accumulates over a lap.
    This is the drift-then-repair world for loop-closure evaluation."""
    rng = np.random.RandomState(seed + 7)
    planes = [Plane(np.array([0.0, ground_y, 0.0]),
                    np.array([0.0, -1.0, 0.0]),
                    np.array([1.0, 0.0, 0.0]),
                    np.array([0.0, 0.0, 1.0]), tex_px_per_m)]
    cx0, cz0 = 0.0, radius
    # APERIODIC layout: regular angular spacing makes every sector of
    # the ring look alike, and place recognition then closes *false*
    # loops a third of a lap early (observed: ATE 200+ m from one bad
    # Sim3).  Spacing, ring offset, pillar size and height all vary per
    # pillar so no two viewpoints share a plausible appearance.
    for ring_sign in (0, 1):
        angs = np.cumsum(rng.uniform(0.5, 1.5, n_pillars))
        angs = angs / angs[-1] * 2 * np.pi
        for k in range(n_pillars):
            ang = angs[k]
            ring_r = radius + ring_offsets[ring_sign] \
                + rng.uniform(-4.0, 4.0)
            side = pillar_side * rng.uniform(0.6, 1.8)
            height = rng.uniform(3.0, 7.0)
            half = side / 2.0
            px = cx0 + ring_r * np.sin(ang)
            pz = cz0 - ring_r * np.cos(ang)
            s = tex_px_per_m * rng.uniform(0.5, 1.6)
            for nx, nz in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                n = np.array([nx, 0.0, nz], np.float64)
                e1 = np.array([-nz, 0.0, nx], np.float64)
                # column standing on the ground plane (y is down)
                planes.append(Plane(
                    np.array([px + nx * half, ground_y - height / 2,
                              pz + nz * half]),
                    n, e1, np.array([0.0, 1.0, 0.0]), s,
                    ext1=half, ext2=height / 2))
    return planes


_MIP_CACHE: dict = {}


def _mips_for(tex: np.ndarray) -> List[np.ndarray]:
    """Box-filtered mip chain, cached per texture object."""
    key = id(tex)
    hit = _MIP_CACHE.get(key)
    if hit is not None and hit[0] is tex:
        return hit[1]
    mips = [tex]
    while mips[-1].shape[0] >= 16 and mips[-1].shape[0] % 2 == 0:
        m = mips[-1]
        mips.append(((m[0::2, 0::2] + m[1::2, 0::2]
                      + m[0::2, 1::2] + m[1::2, 1::2]) * 0.25))
    _MIP_CACHE.clear()          # one world at a time; avoid leaks
    _MIP_CACHE[key] = (tex, mips)
    return mips


def _sample_mip(mips: List[np.ndarray], u: np.ndarray, v: np.ndarray,
                footprint_px: np.ndarray) -> np.ndarray:
    """Trilinear mip sampling: prefiltered texture lookup at the screen
    pixel's footprint.  Plain bilinear sampling of a minified texture
    ALIASES — far-field surfaces shimmer frame to frame, ORB descriptors
    on them churn (measured: only ~7% of adjacent-frame descriptors
    matched within 30 Hamming bits), and BoW place recognition loses its
    signal.  A real camera integrates over the pixel footprint; so must
    the renderer."""
    lvl = np.clip(np.log2(np.maximum(footprint_px, 1.0)), 0.0,
                  len(mips) - 1.001)
    l0 = np.floor(lvl).astype(np.int64)
    fl = (lvl - l0).astype(np.float32)
    out = np.empty(u.shape, np.float32)
    for level in np.unique(l0):
        m = l0 == level
        s0 = 0.5 ** level
        a = _sample_bilinear(mips[level], u[m] * s0, v[m] * s0)
        l1 = min(level + 1, len(mips) - 1)
        s1 = 0.5 ** l1
        b = _sample_bilinear(mips[l1], u[m] * s1, v[m] * s1)
        out[m] = a * (1 - fl[m]) + b * fl[m]
    return out


def _sample_bilinear(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    size = tex.shape[0]
    u = np.mod(u, size)
    v = np.mod(v, size)
    u0 = np.floor(u).astype(np.int64) % size
    v0 = np.floor(v).astype(np.int64) % size
    u1 = (u0 + 1) % size
    v1 = (v0 + 1) % size
    fu = (u - np.floor(u)).astype(np.float32)
    fv = (v - np.floor(v)).astype(np.float32)
    a = tex[v0, u0] * (1 - fu) + tex[v0, u1] * fu
    b = tex[v1, u0] * (1 - fu) + tex[v1, u1] * fu
    return a * (1 - fv) + b * fv


def render_view(
    Twc: np.ndarray,
    K: np.ndarray,
    width: int,
    height: int,
    planes: List[Plane],
    tex: np.ndarray,
) -> np.ndarray:
    """Ray-cast one camera view -> float32 HxW grayscale in [0, 255]."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    dirs_c = np.stack(
        [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], axis=-1
    )
    Rwc = Twc[:3, :3]
    o = Twc[:3, 3]
    dirs_w = dirs_c @ Rwc.T  # (H, W, 3)

    best_t = np.full((height, width), np.inf)
    img = np.full((height, width), 90.0, np.float32)  # sky fallback
    for pl in planes:
        denom = dirs_w @ pl.n
        num = (pl.p0 - o) @ pl.n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(np.abs(denom) > 1e-9, num / denom, np.inf)
        hit = (t > 0.05) & (t < best_t) & (t < 400.0)
        if not hit.any():
            continue
        pts = o + dirs_w[hit] * t[hit, None]
        rel = pts - pl.p0
        if np.isfinite(pl.ext1) or np.isfinite(pl.ext2):
            inside = (np.abs(rel @ pl.e1) <= pl.ext1) \
                & (np.abs(rel @ pl.e2) <= pl.ext2)
            idx = np.nonzero(hit)
            hit = np.zeros_like(hit)
            hit[idx[0][inside], idx[1][inside]] = True
            if not hit.any():
                continue
            rel = rel[inside]
        tu = rel @ pl.e1 * pl.tex_scale
        tv = rel @ pl.e2 * pl.tex_scale
        # pixel footprint on the plane in texture px: angular pixel size
        # (1/fx) x ray distance x slant stretch (||dir||^2 / |dir . n|)
        dir_n2 = np.sum(dirs_w[hit] * dirs_w[hit], axis=-1)
        fp = pl.tex_scale * t[hit] * dir_n2 / (
            fx * np.abs(denom[hit]) + 1e-9)
        vals = _sample_mip(_mips_for(tex), tu, tv, fp)
        # mild distance attenuation for depth cueing
        vals = vals / (1.0 + 0.0015 * t[hit])
        img[hit] = vals.astype(np.float32)
        best_t[hit] = t[hit]
    return np.clip(img, 0, 255).astype(np.float32)


def render_depth(
    Twc: np.ndarray, K: np.ndarray, width: int, height: int,
    planes: Optional[List[Plane]] = None,
) -> np.ndarray:
    """Ground-truth z-depth map (camera frame) for test gating."""
    if planes is None:
        planes = corridor_scene()
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    us, vs = np.meshgrid(np.arange(width), np.arange(height))
    dirs_c = np.stack(
        [(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, np.float64)], axis=-1
    )
    Rwc = Twc[:3, :3]
    o = Twc[:3, 3]
    dirs_w = dirs_c @ Rwc.T
    best_t = np.full((height, width), np.inf)
    for pl in planes:
        denom = dirs_w @ pl.n
        num = (pl.p0 - o) @ pl.n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = np.where(np.abs(denom) > 1e-9, num / denom, np.inf)
        hit = (t > 0.05) & (t < best_t) & (t < 400.0)
        if (np.isfinite(pl.ext1) or np.isfinite(pl.ext2)) and hit.any():
            rel = o + dirs_w[hit] * t[hit, None] - pl.p0
            inside = (np.abs(rel @ pl.e1) <= pl.ext1) \
                & (np.abs(rel @ pl.e2) <= pl.ext2)
            idx = np.nonzero(hit)
            hit = np.zeros_like(hit)
            hit[idx[0][inside], idx[1][inside]] = True
        best_t[hit] = t[hit]
    # ray parameter t is distance along dirs_c whose z-component is 1 -> z = t
    return best_t


def straight_trajectory(n_frames: int, speed: float = 1.0, yaw_amp: float = 0.04) -> np.ndarray:
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


def loop_trajectory(n_frames: int, radius: float = 18.0,
                    laps: float = 1.0) -> np.ndarray:
    """``laps`` circles returning past the start (for loop-closure tests;
    laps > 1 produces repeated revisits — multi-loop-event sequences)."""
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    for i in range(n_frames):
        ang = 2 * np.pi * laps * i / n_frames
        # camera center moves on a circle in the x-z plane, heading tangent
        cxp = radius * np.sin(ang)
        czp = radius * (1 - np.cos(ang))
        yaw = ang
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, 0, 3] = cxp
        poses[i, 2, 3] = czp
    return poses


def _to_u8(img_f32: np.ndarray) -> np.ndarray:
    """Quantize a rendered [0,255] float image to uint8 — the dtype real
    KITTI frames arrive in, and a 4x cheaper host->device transfer."""
    return (np.clip(img_f32, 0, 255) + 0.5).astype(np.uint8)


@dataclasses.dataclass
class SyntheticSequence:
    left: np.ndarray        # (N, H, W) uint8 (KITTI pngs are 8-bit)
    right: np.ndarray
    poses_wc: np.ndarray    # (N, 4, 4) ground-truth Twc (left camera)
    K: np.ndarray           # (3, 3)
    baseline: float         # meters
    timestamps: np.ndarray  # (N,)

    @property
    def bf(self) -> float:
        return float(self.K[0, 0] * self.baseline)


def generate_sequence(
    n_frames: int = 120,
    width: int = 640,
    height: int = 192,
    baseline: float = 0.54,
    trajectory: str = "straight",
    speed: float = 1.0,
    seed: int = 0,
    cache_dir: Optional[str] = None,
    scene_width: float = 16.0,
    loop_radius: float = 18.0,
    laps: float = 1.0,
    scene: str = "corridor",
) -> SyntheticSequence:
    """Render (and optionally disk-cache) a synthetic stereo sequence.

    Note: the trajectory must stay inside the corridor (walls at
    +-scene_width/2); a loop needs scene_width > 2*loop_radius + margin.
    """
    if trajectory == "loop" and scene_width < 2 * loop_radius + 6:
        scene_width = 2 * loop_radius + 12.0
    if trajectory == "straight":
        # the sinusoidal-yaw "straight" path wanders laterally as it
        # integrates; the corridor must CONTAIN it (a camera that crosses
        # a wall sees degenerate geometry and kidnaps the tracker)
        x_extent = float(
            np.abs(straight_trajectory(n_frames, speed=speed)[:, 0, 3]).max())
        scene_width = max(scene_width, 2 * x_extent + 10.0)
    fx = 0.58 * width  # KITTI-like FOV  [generate_sequence]
    K = np.array([[fx, 0, width / 2.0], [0, fx, height / 2.0 - 10.0], [0, 0, 1]])
    key = (f"{n_frames}_{width}_{height}_{baseline}_{trajectory}_{speed}_{seed}"
           f"_{scene_width}_{loop_radius}_v11"
           + (f"_l{laps}" if laps != 1.0 else "")
           + (f"_{scene}" if scene != "corridor" else ""))
    cache_path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        h = hashlib.md5(key.encode()).hexdigest()[:16]
        cache_path = os.path.join(cache_dir, f"synth_{h}.npz")
        if os.path.exists(cache_path):
            d = np.load(cache_path)
            return SyntheticSequence(
                left=d["left"], right=d["right"], poses_wc=d["poses"],
                K=d["K"], baseline=float(d["baseline"]), timestamps=d["times"],
            )

    # keep the texture tile period comfortably above the world extent so
    # distinct places look distinct (see corridor_scene docstring).  For
    # the straight corridor the period must exceed trajectory length +
    # stereo view distance: at the old fixed 1024 px / 48 px-per-m the
    # world repeated every 21.3 m, and the zero-disparity far wall let
    # epipolar/fuse matching lock onto identical features one tile away
    # — coherently mis-placed landmarks that pulled BA cameras meters
    # along z (observed: 6 m keyframe jump at frame ~90 of a 100-frame
    # run)
    if trajectory == "loop":
        tex_size, px_per_m = 4096, 4096.0 / (4.0 * loop_radius + 16.0)
    else:
        length = n_frames * speed + 60.0
        tex_size = 4096
        px_per_m = min(48.0, tex_size / length)
    tex = make_texture(tex_size, seed=seed)
    if scene == "interior":
        # pillar rings flanking the loop: close structure inside the
        # stereo depth gate everywhere on the path (the corridor-loop
        # walls go depth-poor mid-lap and scale drift runs meters/frame
        # — the round-4 finding that motivated interior_loop_scene)
        if trajectory != "loop":
            raise ValueError("scene='interior' requires trajectory='loop'")
        planes = interior_loop_scene(
            loop_radius, tex_px_per_m=px_per_m, seed=seed)
    else:
        planes = corridor_scene(width_m=scene_width, tex_px_per_m=px_per_m)
    if trajectory == "straight":
        poses = straight_trajectory(n_frames, speed=speed)
    elif trajectory == "loop":
        poses = loop_trajectory(n_frames, radius=loop_radius, laps=laps)
    else:
        raise ValueError(f"unknown trajectory {trajectory!r}")

    lefts = np.empty((n_frames, height, width), np.uint8)
    rights = np.empty((n_frames, height, width), np.uint8)
    right_offset = np.array([baseline, 0.0, 0.0])
    for i in range(n_frames):
        Twc = poses[i]
        lefts[i] = _to_u8(render_view(Twc, K, width, height, planes, tex))
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ right_offset
        rights[i] = _to_u8(render_view(Twc_r, K, width, height, planes, tex))

    times = np.arange(n_frames, dtype=np.float64) * 0.1
    if cache_path is not None:
        np.savez_compressed(
            cache_path, left=lefts, right=rights, poses=poses, K=K,
            baseline=baseline, times=times,
        )
    return SyntheticSequence(
        left=lefts, right=rights, poses_wc=poses, K=K,
        baseline=baseline, timestamps=times,
    )


@dataclasses.dataclass
class SyntheticStream:
    """Lazily-rendered synthetic sequence for LONG runs (a 4500-frame
    KITTI-00-shaped sequence does not fit in RAM pre-rendered): poses and
    the world are built once, frames render on demand."""

    n_frames: int
    width: int = 1241
    height: int = 376
    baseline: float = 0.54
    trajectory: str = "loop"
    speed: float = 0.8
    seed: int = 0
    loop_radius: float = 60.0
    laps: float = 1.0
    scene: str = "corridor"   # "corridor" | "interior" (pillar rings)
    cache_dir: Optional[str] = None   # per-frame render cache (npz)
    render_backend: str = "numpy"     # "numpy" | "torch" (io/render_torch.py)
    render_device: str = "cuda"       # the torch renderer's device

    def __post_init__(self):
        scene_width = 16.0
        if self.trajectory == "loop" and self.scene == "interior":
            tex_size = 4096
            px_per_m = 4096.0 / (4.0 * self.loop_radius + 16.0)
        elif self.trajectory == "loop":
            scene_width = 2 * self.loop_radius + 12.0
            tex_size = 4096
            px_per_m = 4096.0 / (4.0 * self.loop_radius + 16.0)
        else:
            tex_size, px_per_m = 4096, 48.0
            x_extent = float(np.abs(
                straight_trajectory(self.n_frames,
                                    speed=self.speed)[:, 0, 3]).max())
            scene_width = max(scene_width, 2 * x_extent + 10.0)
        fx = 0.58 * self.width
        self.K = np.array([
            [fx, 0, self.width / 2.0],
            [0, fx, self.height / 2.0 - 10.0],
            [0, 0, 1]])
        self.bf = fx * self.baseline
        self._tex = make_texture(tex_size, seed=self.seed)
        if self.scene == "interior":
            self._planes = interior_loop_scene(
                self.loop_radius, tex_px_per_m=px_per_m, seed=self.seed)
        else:
            self._planes = corridor_scene(width_m=scene_width,
                                          tex_px_per_m=px_per_m)
        if self.trajectory == "straight":
            self.poses_wc = straight_trajectory(self.n_frames,
                                                speed=self.speed)
        elif self.trajectory == "loop":
            self.poses_wc = loop_trajectory(
                self.n_frames, radius=self.loop_radius, laps=self.laps)
        else:
            raise ValueError(f"unknown trajectory {self.trajectory!r}")
        self.timestamps = np.arange(self.n_frames, dtype=np.float64) * 0.1

    def frame(self, i: int):
        """Render stereo pair i -> (left, right) uint8 arrays.  With
        ``cache_dir`` set, rendered pairs persist to disk, so reruns over
        the same world stream from disk."""
        path = None
        if self.cache_dir is not None:
            os.makedirs(self.cache_dir, exist_ok=True)
            # a world is rendered entirely by ONE backend (pixel-exact
            # parity across backends is not guaranteed): distinct keys
            bk = "" if self.render_backend == "numpy" else "th_"
            key = (f"{self.trajectory}_{self.scene}{_SCENE_VERSION}_{bk}"
                   f"{self.width}x{self.height}_{self.loop_radius}_"
                   f"{self.laps}_{self.seed}_{self.n_frames}_{i}")
            path = os.path.join(self.cache_dir, f"sf_{key}.npz")
            if os.path.exists(path):
                d = np.load(path)
                return d["l"], d["r"]
        Twc = self.poses_wc[i]
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ np.array(
            [self.baseline, 0.0, 0.0])
        if self.render_backend == "torch":
            if not hasattr(self, "_torch_renderer"):
                from pyorbslam_tpu_torch.io.render_torch import TorchRenderer
                self._torch_renderer = TorchRenderer(
                    self._planes, self._tex, self.render_device)
            lu = self._torch_renderer.render(
                Twc, self.K, self.width, self.height)
            ru = self._torch_renderer.render(
                Twc_r, self.K, self.width, self.height)
        elif self.render_backend == "numpy":
            left = render_view(Twc, self.K, self.width, self.height,
                               self._planes, self._tex)
            right = render_view(Twc_r, self.K, self.width, self.height,
                                self._planes, self._tex)
            lu, ru = _to_u8(left), _to_u8(right)
        else:
            raise ValueError(f"unknown render backend {self.render_backend!r}")
        if path is not None:
            np.savez_compressed(path, l=lu, r=ru)
        return lu, ru
