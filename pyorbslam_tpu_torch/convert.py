"""Carry state across between the JAX package and this port.

The system has no weights; its state is the configuration, the frames,
the map and, for a whole ``System``, the tracker's state between two
frames (:func:`system_from_numpy`).  These functions turn the JAX package's values,
taken as numpy arrays, into the port's values on a given device, and
back to numpy.  Descriptor words are the one field whose type differs:
uint32 in the JAX package, int32 with the same bits here, so they cross
as ``.view(np.int32)`` / ``.view(np.uint32)``.

Nothing here imports JAX: a JAX array becomes numpy through
``np.asarray`` on the caller's side, or here, where numpy accepts it.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from pyorbslam_tpu_torch.config import (
    BaConfig, CameraConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from pyorbslam_tpu_torch.optim.ba import BAGridProblem, BAProblem
from pyorbslam_tpu_torch.place.keyframe_db import KeyFrameDatabase
from pyorbslam_tpu_torch.place.vocabulary import Vocabulary
from pyorbslam_tpu_torch.slam.frame import StereoFrame
from pyorbslam_tpu_torch.slam.local_mapping import LocalMapper
from pyorbslam_tpu_torch.slam.loop_closing import LoopCloser
from pyorbslam_tpu_torch.slam.mapstore import KeyFrameStore, LandmarkStore
from pyorbslam_tpu_torch.slam.system import System

MIRROR_FIELDS = ("pos", "desc", "normal", "dmin", "dmax", "alive")


def config_to_dict(cfg: Any) -> Dict[str, dict]:
    """Either package's ``SlamConfig`` -> nested dict of plain fields."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: Mapping[str, Mapping]) -> SlamConfig:
    """Nested dict (``dataclasses.asdict`` of either package's config) ->
    the port's ``SlamConfig``."""
    return SlamConfig(
        camera=CameraConfig(**d["camera"]),
        orb=OrbConfig(**d["orb"]),
        tracking=TrackingConfig(**d["tracking"]),
        ba=BaConfig(**d["ba"]),
    )


def desc_to_port(desc: np.ndarray) -> np.ndarray:
    """uint32 descriptor words -> int32 words with the same bits."""
    return np.ascontiguousarray(np.asarray(desc, np.uint32)).view(np.int32)


def desc_from_port(desc: np.ndarray) -> np.ndarray:
    """int32 descriptor words -> uint32 words with the same bits."""
    return np.ascontiguousarray(np.asarray(desc, np.int32)).view(np.uint32)


def frame_from_numpy(fields: Any, device: torch.device) -> StereoFrame:
    """A JAX ``StereoFrame`` (or any object/mapping with its field names)
    -> the port's ``StereoFrame`` on ``device``."""
    get = fields.__getitem__ if isinstance(fields, Mapping) else \
        (lambda k: getattr(fields, k))
    out = {}
    for name in StereoFrame._fields:
        a = np.asarray(get(name))
        if name == "desc":
            a = desc_to_port(a)
        # a copy: a JAX array's numpy view is read-only
        out[name] = torch.as_tensor(np.array(a, order="C"), device=device)
    return StereoFrame(**out)


def frame_to_numpy(frame: StereoFrame) -> Dict[str, np.ndarray]:
    """The port's ``StereoFrame`` -> dict of numpy arrays in the JAX
    package's types (uint32 descriptors)."""
    out = {k: v.detach().cpu().numpy() for k, v in frame._asdict().items()}
    out["desc"] = desc_from_port(out["desc"])
    return out


def landmarks_from_numpy(src: Any, capacity: int = None) -> LandmarkStore:
    """A JAX ``LandmarkStore`` (numpy arrays) -> the port's store, same
    ids and contents."""
    store = LandmarkStore(capacity or src.capacity)
    n = src.n
    for name in ("pos", "normal", "dmin", "dmax", "n_obs", "visible",
                 "found", "first_kf", "ref_kf", "alive", "replaced_by"):
        getattr(store, name)[:n] = np.asarray(getattr(src, name))[:n]
    store.desc[:n] = desc_to_port(np.asarray(src.desc)[:n])
    store.n = n
    return store


def landmarks_to_numpy(store: LandmarkStore) -> Dict[str, np.ndarray]:
    """The port's store -> dict of its first ``n`` rows, uint32 descriptors."""
    n = store.n
    out = {name: getattr(store, name)[:n].copy() for name in (
        "pos", "normal", "dmin", "dmax", "n_obs", "visible", "found",
        "first_kf", "ref_kf", "alive", "replaced_by")}
    out["desc"] = desc_from_port(store.desc[:n])
    return out


def landmark_mirror(store: LandmarkStore, device: torch.device
                    ) -> Dict[str, torch.Tensor]:
    """The device-resident landmark mirror the fused steps read
    (pos, desc, normal, dmin, dmax, alive), one row per store slot.  A
    copy, also on the CPU: later writes to the store leave it frozen."""
    return {name: torch.tensor(getattr(store, name), device=device)
            for name in MIRROR_FIELDS}


def tensor_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    """Any array (numpy or JAX) -> a tensor on ``device``; uint32 words
    become int32 with the same bits.  A copy: a JAX array's numpy view is
    read-only."""
    a = np.array(a, order="C")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device)


def vocabulary_from_numpy(src: Any) -> Vocabulary:
    """A JAX-side ``Vocabulary`` (numpy fields, uint32 node descriptors)
    -> the port's (int32 words with the same bits)."""
    return Vocabulary(
        k=int(src.k), L=int(src.L),
        node_desc=desc_to_port(np.asarray(src.node_desc)).copy(),
        child_start=np.array(src.child_start, np.int32),
        n_children=np.array(src.n_children, np.int32),
        weight=np.array(src.weight, np.float32),
        word_id=np.array(src.word_id, np.int32),
        n_words=int(src.n_words))


def ba_problem_from_numpy(src: Any, device: torch.device):
    """A JAX ``BAProblem`` or ``BAGridProblem`` (same field names) -> the
    port's problem on ``device``."""
    cls = BAGridProblem if hasattr(src, "g_cam") else BAProblem
    return cls(**{f: tensor_from_numpy(getattr(src, f), device)
                  for f in cls._fields})


KEYFRAME_FIELDS = ("Tcw", "frame_id", "timestamp", "alive", "kp_xy",
                   "kp_octave", "kp_angle", "kp_node", "kp_valid", "u_right",
                   "depth", "obs_lm")


def keyframes_from_numpy(src: Any, capacity: int = None) -> KeyFrameStore:
    """A JAX ``KeyFrameStore`` (numpy arrays) -> the port's store, same
    ids and contents."""
    store = KeyFrameStore(capacity or src.capacity, src.n_features)
    n = src.n
    for name in KEYFRAME_FIELDS:
        getattr(store, name)[:n] = np.asarray(getattr(src, name))[:n]
    store.kp_desc[:n] = desc_to_port(np.asarray(src.kp_desc)[:n])
    store.n = n
    return store


def ring_from_numpy(arrays: Any, device: torch.device) -> tuple:
    """A JAX ``DeviceKFRing.arrays`` tuple (xy, octave, desc, u_right,
    depth, valid) -> the port's ring tensors on ``device``."""
    return tuple(tensor_from_numpy(a, device) for a in arrays)


def loop_closer_from_numpy(src: Any, cfg: SlamConfig, m, voc: Vocabulary,
                           kfdb: KeyFrameDatabase) -> LoopCloser:
    """A JAX ``LoopCloser``'s state -> the port's, over the port's map and
    keyframe database: consistency groups, last loop keyframe, the three
    counters, the Sim3 failure cooldown and the pending global-BA budget."""
    lc = LoopCloser(cfg, m, voc, kfdb, consistency_th=src.consistency_th)
    lc.prev_groups = [({int(k) for k in g}, int(c)) for g, c in src.prev_groups]
    lc.last_loop_kf = int(src.last_loop_kf)
    lc.n_loops_closed = int(src.n_loops_closed)
    lc.n_loops_rejected = int(src.n_loops_rejected)
    lc.n_loops_fused = int(src.n_loops_fused)
    lc._sim3_fail.extend(({int(k) for k in g}, int(k0))
                         for g, k0 in src._sim3_fail)
    lc._gba_remaining = int(getattr(src, "_gba_remaining", 0))
    return lc


def system_from_numpy(src: Any, cfg: SlamConfig, device: torch.device) -> System:
    """A JAX ``System`` between two frames -> the port's ``System`` on
    ``device`` in the same state: vocabulary, map (landmarks, keyframes,
    spanning tree, loop edges, culled-keyframe anchors; the native index is
    rebuilt from the observation table, so observation counts and
    covisibility are recounted), keyframe database, keyframe ring, the loop
    closer's state (consistency groups, last loop keyframe, counters, Sim3
    failure cooldown, pending global-BA budget) and the tracker's state
    (pose, velocity, last frame and its landmark bindings, trajectory and
    relative-pose log, keyframe bookkeeping).  The port's ``System`` takes
    the source's ``enable_loop_closing``.  The source must have nothing in
    flight (``flush_async()`` / ``shutdown()`` first)."""
    if src._async_q or src._maint_queue or src._maint_pipe \
            or getattr(src, "_pending_window", None) is not None:
        raise ValueError("the source System has frames or mapping work in "
                         "flight; flush it before carrying its state over")
    voc = vocabulary_from_numpy(src.vocabulary) if src.vocabulary is not None \
        else None
    out = System(cfg, device, landmark_capacity=src.landmark_capacity,
                 keyframe_capacity=src.keyframe_capacity,
                 ba_every_n_kf=src.ba_every_n_kf,
                 window_commit_min_inliers=src.window_commit_min_inliers,
                 localization_only=src.localization_only,
                 enable_loop_closing=src.enable_loop_closing, vocabulary=voc)
    m = out.map
    m.landmarks = landmarks_from_numpy(src.map.landmarks)
    m.keyframes = keyframes_from_numpy(src.map.keyframes)
    m.parent = dict(src.map.parent)
    m.children = {k: set(v) for k, v in src.map.children.items()}
    m.loop_edges = {int(k): {int(j) for j in v}
                    for k, v in src.map.loop_edges.items()}
    m.dead_anchor = {k: (int(p), np.array(T, np.float32))
                     for k, (p, T) in src.map.dead_anchor.items()}
    m.rebuild_core()

    if src.kfdb is not None:
        out.kfdb = KeyFrameDatabase(voc)
        for kf, bow in src.kfdb.bow.items():
            out.kfdb.add(int(kf), dict(bow))
    ring = src.kf_ring
    if ring.arrays is not None:
        out.kf_ring.arrays = ring_from_numpy(ring.arrays, device)
        out.kf_ring.slot_of = dict(ring.slot_of)
        out.kf_ring._kf_at = list(ring._kf_at)
        out.kf_ring._next = ring._next
    if src.local_mapper is not None:
        out.local_mapper = LocalMapper(cfg, m, ring=out.kf_ring,
                                       mirror_fn=out._landmark_mirror)
    if getattr(src, "loop_closer", None) is not None:
        out.loop_closer = loop_closer_from_numpy(src.loop_closer, cfg, m,
                                                 voc, out.kfdb)

    out.state = src.state
    out.Tcw = np.array(src.Tcw, np.float32)
    out.velocity = np.array(src.velocity, np.float32)
    if src.last_frame is not None:
        out.last_frame = frame_from_numpy(src.last_frame, device)
        out.last_assign = np.array(src.last_assign, np.int32)
    out.lm_created_kf = np.array(src.lm_created_kf, np.int32)
    out.recent_lms = [np.array(a) for a in src.recent_lms]
    out.last_kf_frame = src.last_kf_frame
    out.last_reloc_frame = src.last_reloc_frame
    out.frame_id = src.frame_id
    out.trajectory = [np.array(T, np.float32) for T in src.trajectory]
    out.frame_refs = [(int(r), np.array(T, np.float32))
                      for r, T in src.frame_refs]
    out.stats = copy.deepcopy(list(src.stats))
    return out
