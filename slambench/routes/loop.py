"""The loop route: a circle driven past its start, through the interior
loop world (ground and two rings of square pillars flanking the path).

Frozen from ``pyorbslam_tpu_torch/io/synthetic.py`` at commit fde81bb:
``loop_trajectory``, ``interior_loop_scene`` (its layout drawn from
``RandomState(seed + 7)``) and the loop's texture scale in
``generate_sequence``, 4096 / (4 R + 16) px a metre.  The traffic file
gives ``loop_radius_m``, ``laps`` and ``layout_seed`` (the pillar layout,
fixed as the corridor's walls are); ``--seed`` draws the texture.

Each pillar face carries a texture origin of its own (``face_origins``),
drawn from a stream seeded from ``layout_seed`` apart from the layout's,
so that the layout stays the port's and no two faces sample overlapping
rectangles of the texture: a face looks like another only where the
route comes back to it.  The ground keeps origin (0, 0).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from world import TEX_SIZE, Plane

# level-0 pixels kept between two faces' rectangles, a texel at mip level
# 4: a face's bilinear reads at levels 0-3 stay clear of its neighbours
ORIGIN_GAP = 16.0
ORIGIN_TRIES = 10_000


def loop_trajectory(n_frames: int, radius: float = 18.0,
                    laps: float = 1.0) -> np.ndarray:
    """``laps`` circles returning past the start -> (N, 4, 4) Twc; the
    camera centre moves on a circle in the x-z plane, heading tangent."""
    poses = np.tile(np.eye(4), (n_frames, 1, 1))
    for i in range(n_frames):
        ang = 2 * np.pi * laps * i / n_frames
        cxp = radius * np.sin(ang)
        czp = radius * (1 - np.cos(ang))
        yaw = ang
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i, :3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, 0, 3] = cxp
        poses[i, 2, 3] = czp
    return poses


def interior_loop_scene(radius: float, ground_y: float = 1.7,
                        tex_px_per_m: float = 48.0,
                        n_pillars: int = 16, pillar_side: float = 2.0,
                        ring_offsets=(-9.0, 11.0),
                        seed: int = 0) -> List[Plane]:
    """Textured ground plus two rings of square pillars flanking the
    circle (centre (0, radius) in x-z), inside the stereo depth gate
    everywhere on the path.  The layout is aperiodic (spacing, ring
    offset, size and height vary per pillar), and each face samples a
    rectangle of the texture of its own (``face_origins``)."""
    rng = np.random.RandomState(seed + 7)
    planes = [Plane(np.array([0.0, ground_y, 0.0]),
                    np.array([0.0, -1.0, 0.0]),
                    np.array([1.0, 0.0, 0.0]),
                    np.array([0.0, 0.0, 1.0]), tex_px_per_m)]
    cx0, cz0 = 0.0, radius
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
                # a column standing on the ground plane (y is down)
                planes.append(Plane(
                    np.array([px + nx * half, ground_y - height / 2,
                              pz + nz * half]),
                    n, e1, np.array([0.0, 1.0, 0.0]), s,
                    ext1=half, ext2=height / 2))
    return planes[:1] + face_origins(planes[1:], seed)


def face_origins(faces: List[Plane], seed: int) -> List[Plane]:
    """The bounded ``faces``, each with a texture origin drawn so that no
    two faces' rectangles (origin ± ext × tex_scale on each axis, in
    level-0 pixels, modulo the texture's size) come within ``ORIGIN_GAP``
    pixels of each other: rejection sampling from ``RandomState([seed,
    1])``, a stream apart from the layout's ``RandomState(seed + 7)``."""
    rng = np.random.RandomState([seed, 1])
    centres, halves, out = np.zeros((0, 2)), np.zeros((0, 2)), []
    for face in faces:
        half = np.array([face.ext1, face.ext2]) * face.tex_scale
        for _ in range(ORIGIN_TRIES):
            c = rng.uniform(0.0, TEX_SIZE, 2)
            d = np.abs(centres - c) % TEX_SIZE
            d = np.minimum(d, TEX_SIZE - d)
            if not (d < halves + half + ORIGIN_GAP).all(axis=1).any():
                break
        else:
            raise ValueError(f"no room in the texture for {len(faces)} faces")
        centres, halves = np.vstack([centres, c]), np.vstack([halves, half])
        out.append(dataclasses.replace(face, tex_origin=(float(c[0]), float(c[1]))))
    return out


def poses(traffic: dict, n_frames: int) -> np.ndarray:
    return loop_trajectory(n_frames, radius=traffic["loop_radius_m"],
                           laps=traffic["laps"])


def scene(traffic: dict, poses: np.ndarray) -> List[Plane]:
    if traffic["scene"] != "interior":
        raise ValueError(f"scene {traffic['scene']!r}: the loop route has only 'interior'")
    radius = traffic["loop_radius_m"]
    return interior_loop_scene(radius, tex_px_per_m=TEX_SIZE / (4.0 * radius + 16.0),
                               seed=traffic["layout_seed"])
