"""KITTI stereo CLI of the PyTorch port (reference parity:
stereo_kitti.py:12-59; the counterpart of the repository's
``stereo_kitti.py``).

Usage:
    python3 -m pyorbslam_tpu_torch.stereo_kitti --pathToSequence <seq_dir> \
        --pathToVocabulary <ORBvoc.txt or "auto"> \
        --pathToSettings <KITTIxx.yaml> [--output CameraTrajectory.txt] \
        [--async | --window W] [--device cuda] [--viewer PORT]

The sequence dir must contain image_2/, image_3/, times.txt (KITTI
odometry layout).  Vocabulary "auto" (or a missing file) uses the shipped
vocabulary asset, or trains a scene vocabulary from the first frame.

``--device`` names the device every step runs on (default ``cuda``).
Nothing falls back: with ``cuda`` and no CUDA device the command fails.
The system runs with loop closing on, as the repository's CLI does.
``--window W`` tracks W frames a dispatch through
``System.track_stereo_window``; a tail shorter than a window is tracked
frame by frame.  ``--viewer PORT`` serves the live viewer
(``viz/live_viewer.py``) at http://localhost:PORT/ while the system
tracks.
"""

import argparse
import os
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pathToSequence", required=True)
    ap.add_argument("--pathToVocabulary", default="auto")
    ap.add_argument("--pathToSettings", required=True)
    ap.add_argument("--output", default="CameraTrajectory.txt")
    ap.add_argument("--maxFrames", type=int, default=0)
    ap.add_argument("--window", type=int, default=0,
                    help="track W frames per device dispatch "
                         "(System.track_stereo_window); 0 = per frame")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="pipelined per-frame schedule "
                         "(System.track_stereo_async)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every step (default: cuda)")
    ap.add_argument("--viewer", type=int, default=0, metavar="PORT",
                    help="serve the live map/frame viewer on this port "
                         "(the reference Viewer thread, Viewer.py:40)")
    args = ap.parse_args(argv)

    import torch

    from pyorbslam_tpu_torch.config import SlamConfig
    from pyorbslam_tpu_torch.io.kitti import load_image_paths
    from pyorbslam_tpu_torch.slam.system import System

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {args.device}: no CUDA device is available "
            "(pass --device cpu to run on the CPU)")

    cfg = SlamConfig.from_yaml(args.pathToSettings)

    vocabulary = None
    if args.pathToVocabulary != "auto" and os.path.exists(args.pathToVocabulary):
        from pyorbslam_tpu_torch.place.vocabulary import Vocabulary

        print(f"loading vocabulary {args.pathToVocabulary} ...")
        vocabulary = Vocabulary.load_text(args.pathToVocabulary)

    system = System(cfg, device, vocabulary=vocabulary)

    left_paths, _, times = load_image_paths(args.pathToSequence)
    n = len(left_paths)
    if args.maxFrames:
        n = min(n, args.maxFrames)
    print(f"tracking {n} frames from {args.pathToSequence} on {device}")

    viewer = None
    if args.viewer:
        from pyorbslam_tpu_torch.viz.live_viewer import LiveViewer

        viewer = LiveViewer(system, port=args.viewer).start()
        print(f"live viewer: http://localhost:{viewer.port}/")
    try:
        _track(system, args, n, viewer)
    finally:
        if viewer is not None:
            viewer.stop()


def _track(system, args, n: int, viewer) -> None:
    from pyorbslam_tpu_torch.io.kitti import iter_stereo

    t_start = time.time()
    if args.window:
        buf = []
        for i, (left, right, ts) in enumerate(iter_stereo(args.pathToSequence)):
            if i >= n:
                break
            buf.append((left, right, ts))
            if len(buf) == args.window:
                system.track_stereo_window(*map(list, zip(*buf)))
                buf = []
                print(f"frame {i + 1}/{n}  state={system.state} "
                      f"kfs={system.map.keyframes.n}")
        for left, right, ts in buf:   # tail shorter than one window
            system.track_stereo(left, right, ts)
    else:
        track = (system.track_stereo_async if args.async_mode
                 else system.track_stereo)
        for i, (left, right, ts) in enumerate(iter_stereo(args.pathToSequence)):
            if i >= n:
                break
            if viewer is not None:
                system._viewer_image = left
            track(left, right, ts)
            if (i + 1) % 50 == 0:
                st = system.stats[-1] if system.stats else {}
                print(f"frame {i + 1}/{n}  state={system.state} "
                      f"inliers={st.get('inliers', '-')} kfs={system.map.keyframes.n}")
        if args.async_mode:
            system.flush_async()
    dt = time.time() - t_start

    system.save_trajectory_kitti(args.output)
    system.shutdown()
    print(f"done: {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps); "
          f"trajectory -> {args.output}")


if __name__ == "__main__":
    main()
