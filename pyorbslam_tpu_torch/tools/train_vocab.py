"""Offline vocabulary training with the port: the ORB descriptors of many
synthetic worlds (several seeds, straight and loop trajectories), built by
the port's frontend on ``--device``, clustered by recursive k-majority
k-means into a k-ary tree of depth L, with the leaves' idf weights taken
over the training frames as documents (TemplatedVocabulary.create
semantics).  The counterpart of the repository's ``tools/train_vocab.py``.

    python3 -m pyorbslam_tpu_torch.tools.train_vocab --out FILE.npz
        [--scenes 24] [--frames 24] [--width 640] [--height 192]
        [--features 1500] [--k 10] [--L 5] [--device cuda]

The frontend (``build_stereo_frame``: the FAST and rBRIEF kernels once a
frame on a card) runs on ``--device`` (default ``cuda``; nothing falls
back: with ``cuda`` and no CUDA device the command fails); the training
runs on the host (``place/vocabulary.py``).  ``--out`` is required and may
not lie inside the JAX package: the shipped asset
(``pyorbslam_tpu/assets/orb_vocab.npz``, read by both packages) is
replaced, if ever, by hand.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from pyorbslam_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_tpu_torch.io.synthetic import generate_sequence
from pyorbslam_tpu_torch.place import vocabulary as vocab_mod
from pyorbslam_tpu_torch.slam.frame import build_stereo_frame
from pyorbslam_tpu_torch.utils.device import device_of
from pyorbslam_tpu_torch.utils.host_read import upload

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_PACKAGE = os.path.join(REPO, "pyorbslam_tpu")
TRAJECTORIES = ("straight", "loop")
FIRST_SEED = 100


def check_out(path: str) -> str:
    """``path`` made absolute; a path inside the JAX package is refused."""
    out = os.path.realpath(path)
    if os.path.commonpath([out, os.path.realpath(JAX_PACKAGE)]) == \
            os.path.realpath(JAX_PACKAGE):
        raise SystemExit(f"--out {path}: the port writes nothing under "
                         f"{JAX_PACKAGE}")
    return out


def scene_sequence(s: int, frames: int, width: int, height: int):
    """Scene ``s`` of the training set: its trajectory alternates, its seed
    counts up from ``FIRST_SEED`` (the repository's tool's worlds)."""
    return generate_sequence(
        n_frames=frames, width=width, height=height,
        trajectory=TRAJECTORIES[s % len(TRAJECTORIES)], seed=FIRST_SEED + s)


def frame_features(seq, features: int, device) -> list:
    """(xy, desc) of the valid features of every frame of ``seq``, built by
    the port's frontend on ``device``: one document a frame."""
    height, width = seq.left.shape[1:]
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=width, height=height, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=features),
    )
    out = []
    for i in range(len(seq.timestamps)):
        frame = build_stereo_frame(upload(seq.left[i], device),
                                   upload(seq.right[i], device), cfg)
        valid = frame.valid.cpu().numpy()
        out.append((frame.xy.cpu().numpy()[valid], frame.desc.cpu().numpy()[valid]))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--features", type=int, default=1500)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=5)
    ap.add_argument("--out", required=True, help="the vocabulary file (npz)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the frontend (default: cuda)")
    args = ap.parse_args(argv)
    out = check_out(args.out)
    device = device_of(args.device)

    docs = []
    t0 = time.time()
    for s in range(args.scenes):
        seq = scene_sequence(s, args.frames, args.width, args.height)
        docs += [desc for _, desc in frame_features(seq, args.features, device)]
        print(f"scene {s + 1}/{args.scenes}: "
              f"{sum(len(d) for d in docs)} descriptors "
              f"({time.time() - t0:.0f}s)", flush=True)

    corpus = np.concatenate(docs)
    print(f"training k={args.k} L={args.L} on {len(corpus)} descriptors "
          f"from {len(docs)} documents...", flush=True)
    t1 = time.time()
    voc = vocab_mod.train(corpus, k=args.k, L=args.L, seed=0)
    print(f"trained: {voc.n_words} words, {len(voc.node_desc)} nodes "
          f"({time.time() - t1:.0f}s)", flush=True)
    t2 = time.time()
    vocab_mod.set_idf_weights(voc, docs)
    nz = int((voc.weight[voc.word_id >= 0] > 0).sum())
    print(f"idf: {nz}/{voc.n_words} words seen in corpus "
          f"({time.time() - t2:.0f}s)", flush=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    vocab_mod.save_npz(voc, out)
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.1f} MB)")
    return voc


if __name__ == "__main__":
    main()
