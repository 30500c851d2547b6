"""Write a synthetic stereo sequence in the KITTI odometry layout, so the
port's CLI (``python3 -m pyorbslam_tpu_torch.stereo_kitti``) can be driven
end to end where no KITTI sequence is at hand: ``image_2/`` and
``image_3/`` (8-bit PNGs), ``times.txt``, ``poses.txt`` (ground truth,
3x4 row-major Twc a line) and a matching ``settings.yaml``.  The same
files as the repository's ``tools/make_kitti_synth.py``.

    python3 -m pyorbslam_tpu_torch.tools.make_kitti_synth --out DIR
        [--frames 60] [--width 640] [--height 192]
        [--trajectory straight|loop] [--seed 3]

The repository's tool also offers ``--trajectory turn``, which no generator
draws (its call raises); it is not offered here.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from pyorbslam_tpu_torch.io.synthetic import generate_sequence

SETTINGS = """%YAML:1.0
Camera.fx: {fx}
Camera.fy: {fy}
Camera.cx: {cx}
Camera.cy: {cy}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {width}
Camera.height: {height}
Camera.fps: 10.0
Camera.bf: {bf}
Camera.RGB: 1
ThDepth: 40
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def write_kitti(seq, out: str) -> str:
    """Write ``seq`` under ``out`` in the KITTI layout; returns the
    settings file's path."""
    import cv2

    n = len(seq.timestamps)
    height, width = seq.left.shape[1:]
    for sub, images in (("image_2", seq.left), ("image_3", seq.right)):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
        for i in range(n):
            path = os.path.join(out, sub, f"{i:06d}.png")
            if not cv2.imwrite(path, np.clip(images[i], 0, 255).astype(np.uint8)):
                raise OSError(f"could not write {path}")
    np.savetxt(os.path.join(out, "times.txt"), seq.timestamps, "%.6f")
    with open(os.path.join(out, "poses.txt"), "w") as f:
        for T in seq.poses_wc:
            f.write(" ".join(f"{x:.9e}" for x in T[:3].reshape(-1)) + "\n")
    K = seq.K
    settings = os.path.join(out, "settings.yaml")
    with open(settings, "w") as f:
        f.write(SETTINGS.format(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2],
                                width=width, height=height, bf=seq.bf))
    return settings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--trajectory", default="straight", choices=["straight", "loop"])
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)

    seq = generate_sequence(
        n_frames=args.frames, width=args.width, height=args.height,
        trajectory=args.trajectory, speed=0.8, seed=args.seed)
    settings = write_kitti(seq, args.out)
    print(f"wrote {args.frames} frames + times.txt + poses.txt + {settings}")


if __name__ == "__main__":
    main()
