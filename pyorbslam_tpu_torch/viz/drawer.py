"""Offline visualization: frame overlay + map rendering.

Port of ``pyorbslam_tpu/viz/drawer.py``: the headless counterpart of the
reference's Pangolin/OpenCV viewer stack (Viewer.py / FrameDrawer.py /
MapDrawer.py), with the same content (tracked keypoints with status bar,
map points, keyframe frusta, covisibility graph, spanning tree, loop
edges) drawn to image files with matplotlib.  It reads host state only,
and imports matplotlib when it draws.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def draw_frame(
    image: np.ndarray,
    xy: np.ndarray,
    tracked: np.ndarray,
    state: str,
    n_kfs: int,
    n_landmarks: int,
    path: str,
):
    """FrameDrawer.draw_frame: keypoints (green = tracked map point) over
    the image + status text (FrameDrawer.py:21-116)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(image.shape[1] / 100, image.shape[0] / 100))
    ax.imshow(image, cmap="gray", vmin=0, vmax=255)
    t = tracked.astype(bool)
    ax.scatter(xy[~t, 0], xy[~t, 1], s=4, c="tab:blue", marker="s", linewidths=0)
    ax.scatter(xy[t, 0], xy[t, 1], s=6, c="lime", marker="s", linewidths=0)
    ax.set_title(
        f"{state} | KFs: {n_kfs} | MPs: {n_landmarks} | matches: {int(t.sum())}",
        fontsize=9,
    )
    ax.set_axis_off()
    fig.savefig(path, bbox_inches="tight", dpi=100)
    plt.close(fig)


def draw_map(
    slam_map,
    trajectory_wc: Optional[np.ndarray],
    path: str,
    covis_weight_th: int = 100,
):
    """MapDrawer content, top-down (x-z) view: landmarks, keyframe frusta,
    covisibility edges (w >= 100), spanning tree, loop edges
    (MapDrawer.py:21-121)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    m = slam_map
    lm = m.landmarks
    ks = m.keyframes
    fig, ax = plt.subplots(figsize=(9, 9))

    alive = np.nonzero(lm.alive[: lm.n])[0]
    if len(alive):
        ax.scatter(lm.pos[alive, 0], lm.pos[alive, 2], s=0.5, c="k", alpha=0.3)

    centers = {}
    for k in range(ks.n):
        if not ks.alive[k]:
            continue
        T = ks.Tcw[k]
        Ow = -T[:3, :3].T @ T[:3, 3]
        centers[k] = Ow
        fwd = T[:3, :3].T @ np.array([0, 0, 1.0])
        ax.plot([Ow[0], Ow[0] + fwd[0]], [Ow[2], Ow[2] + fwd[2]],
                c="tab:blue", lw=0.8)
        ax.scatter([Ow[0]], [Ow[2]], s=6, c="tab:blue")

    ca, cb, cw = m.core.covis_edges()
    for a, b, w in zip(ca.tolist(), cb.tolist(), cw.tolist()):
        if w >= covis_weight_th and a in centers and b in centers:
            ax.plot([centers[a][0], centers[b][0]],
                    [centers[a][2], centers[b][2]], c="green",
                    lw=0.5, alpha=0.5)
    for child, parent in m.parent.items():
        if child in centers and parent in centers:
            ax.plot([centers[child][0], centers[parent][0]],
                    [centers[child][2], centers[parent][2]], c="gray",
                    lw=0.4, alpha=0.6)
    for a, bs in m.loop_edges.items():
        for b in bs:
            if b > a and a in centers and b in centers:
                ax.plot([centers[a][0], centers[b][0]],
                        [centers[a][2], centers[b][2]], c="red", lw=1.5)

    if trajectory_wc is not None and len(trajectory_wc):
        p = trajectory_wc[:, :3, 3]
        ax.plot(p[:, 0], p[:, 2], c="tab:orange", lw=1.0, label="trajectory")
        ax.legend(loc="upper right", fontsize=8)

    ax.set_aspect("equal")
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_title(f"map: {len(alive)} points, {int(ks.alive[:ks.n].sum())} keyframes")
    fig.savefig(path, bbox_inches="tight", dpi=110)
    plt.close(fig)
