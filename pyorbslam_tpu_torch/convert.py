"""Carry state across between the JAX package and this port.

The system has no weights; its state is the configuration, the frames
and the landmark store.  These functions turn the JAX package's values,
taken as numpy arrays, into the port's values on a given device, and
back to numpy.  Descriptor words are the one field whose type differs:
uint32 in the JAX package, int32 with the same bits here, so they cross
as ``.view(np.int32)`` / ``.view(np.uint32)``.

Nothing here imports JAX: a JAX array becomes numpy through
``np.asarray`` on the caller's side, or here, where numpy accepts it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from pyorbslam_tpu_torch.config import (
    BaConfig, CameraConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from pyorbslam_tpu_torch.slam.frame import StereoFrame
from pyorbslam_tpu_torch.slam.mapstore import LandmarkStore

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
