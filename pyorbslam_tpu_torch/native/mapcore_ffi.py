"""ctypes bindings for the port's native map core (built at first use).

Port of ``pyorbslam_tpu/native/mapcore_ffi.py``.  The MapCore attaches
to the Python stores' preallocated numpy arrays (obs_lm / u_right /
kp_octave / n_obs / alive / replaced_by / found / visible) and mutates
them in place: one owner for observation state, no copies across the
boundary.

``native/mapcore.cpp`` compiles with the host ``g++`` at first use into
``pyorbslam_tpu_torch/_build/``; the library's file name carries the
hash of the source, so an edited source is rebuilt.  A failed build
raises.  Nothing under ``pyorbslam_tpu/native/`` is read or written.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "mapcore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

_lib = None

_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libmapcore_{digest}.so")


def build() -> str:
    """Compile the map core unless its library is up to date; returns the
    library's path.  Raises ``RuntimeError`` with the compiler's output
    when the build fails."""
    lib = library_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", SOURCE, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the map core cannot be built") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.mapcore_create.restype = ctypes.c_void_p
    lib.mapcore_create.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
        _I32, _F32, _I32, _I32, _U8, _I32, _I32, _I32,
    ]
    for fn in ("mapcore_free", "mapcore_add_keyframe",
               "mapcore_add_observation", "mapcore_add_observations",
               "mapcore_kill_landmark", "mapcore_replace_landmark",
               "mapcore_remove_keyframe", "mapcore_first_observers",
               "mapcore_redundancy"):
        getattr(lib, fn).restype = None
    for fn in ("mapcore_erase_observation", "mapcore_drain_dirty",
               "mapcore_n_observers",
               "mapcore_observers", "mapcore_observers_csr",
               "mapcore_observed_landmarks", "mapcore_update_connections",
               "mapcore_neighbors", "mapcore_covis_weight",
               "mapcore_covis_edges", "mapcore_local_points",
               "mapcore_local_ba_gather", "mapcore_assemble_obs"):
        getattr(lib, fn).restype = ctypes.c_int32
    _lib = lib
    return lib


def available() -> bool:
    """True when the map core builds and loads here (``g++`` present)."""
    try:
        return _load() is not None
    except (RuntimeError, OSError):
        return False


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(_I32)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(_F32)


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8)


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


class MapCore:
    """Native observation index + covisibility graph, attached to the
    Python stores' arrays (see mapcore.cpp)."""

    def __init__(self, obs_lm: np.ndarray, u_right: np.ndarray,
                 kp_octave: np.ndarray, n_obs: np.ndarray,
                 alive: np.ndarray, replaced_by: np.ndarray,
                 found: np.ndarray, visible: np.ndarray):
        lib = _load()
        assert obs_lm.dtype == np.int32 and obs_lm.flags.c_contiguous
        assert u_right.dtype == np.float32 and u_right.flags.c_contiguous
        assert kp_octave.dtype == np.int32 and kp_octave.flags.c_contiguous
        assert n_obs.dtype == np.int32 and alive.dtype == np.bool_
        self._lib = lib
        kf_cap, n_feat = obs_lm.shape
        self._keep = (obs_lm, u_right, kp_octave, n_obs, alive,
                      replaced_by, found, visible)
        self._h = ctypes.c_void_p(lib.mapcore_create(
            kf_cap, n_feat, len(n_obs),
            _i32p(obs_lm), _f32p(u_right), _i32p(kp_octave),
            _i32p(n_obs), _u8p(alive), _i32p(replaced_by),
            _i32p(found), _i32p(visible)))
        self.n_features = n_feat

    def __del__(self):
        if getattr(self, "_h", None) and self._lib:
            self._lib.mapcore_free(self._h)

    # ---- observation index ----

    def add_keyframe(self, kf: int):
        self._lib.mapcore_add_keyframe(self._h, kf)

    def add_observation(self, lm: int, kf: int, feat: int):
        self._lib.mapcore_add_observation(self._h, lm, kf, feat)

    def add_observations(self, lms, kfs, feats):
        lms = _as_i32(lms)
        kfs = _as_i32(np.broadcast_to(np.asarray(kfs, np.int32), lms.shape))
        feats = _as_i32(feats)
        self._lib.mapcore_add_observations(
            self._h, _i32p(lms), _i32p(kfs), _i32p(feats), len(lms))

    def erase_observation(self, lm: int, kf: int) -> bool:
        return bool(self._lib.mapcore_erase_observation(self._h, lm, kf))

    def kill_landmark(self, lm: int):
        self._lib.mapcore_kill_landmark(self._h, lm)

    def replace_landmark(self, lm: int, by: int):
        self._lib.mapcore_replace_landmark(self._h, lm, by)

    def remove_keyframe(self, kf: int):
        self._lib.mapcore_remove_keyframe(self._h, kf)

    def drain_dirty(self, cap: int = 1 << 16) -> np.ndarray:
        """Landmark ids whose alive flag the core flipped since the last
        drain (kills inside erase/replace/remove paths) — feeds the
        device-mirror delta update."""
        out = np.empty(cap, np.int32)
        n = self._lib.mapcore_drain_dirty(self._h, _i32p(out), cap)
        ids = out[:n].copy()
        while n == cap:
            n = self._lib.mapcore_drain_dirty(self._h, _i32p(out), cap)
            ids = np.concatenate([ids, out[:n]])
        return ids

    def n_observers(self, lm: int) -> int:
        return self._lib.mapcore_n_observers(self._h, lm)

    def observers(self, lm: int, cap: int = 512) -> Tuple[np.ndarray, np.ndarray]:
        kfs = np.empty(cap, np.int32)
        feats = np.empty(cap, np.int32)
        n = self._lib.mapcore_observers(self._h, lm, _i32p(kfs),
                                        _i32p(feats), cap)
        return kfs[:n], feats[:n]

    def observers_csr(self, lm_ids, cap: int = 1 << 20):
        lm_ids = _as_i32(lm_ids)
        off = np.empty(len(lm_ids) + 1, np.int32)
        kfs = np.empty(cap, np.int32)
        feats = np.empty(cap, np.int32)
        t = self._lib.mapcore_observers_csr(
            self._h, _i32p(lm_ids), len(lm_ids), _i32p(off), _i32p(kfs),
            _i32p(feats), cap)
        return off, kfs[:t], feats[:t]

    def first_observers(self, lm_ids):
        lm_ids = _as_i32(lm_ids)
        kfs = np.empty(len(lm_ids), np.int32)
        feats = np.empty(len(lm_ids), np.int32)
        self._lib.mapcore_first_observers(
            self._h, _i32p(lm_ids), len(lm_ids), _i32p(kfs), _i32p(feats))
        return kfs, feats

    def observed_landmarks(self, lm_hi: int, cap: int = 1 << 20) -> np.ndarray:
        out = np.empty(cap, np.int32)
        n = self._lib.mapcore_observed_landmarks(self._h, _i32p(out), cap,
                                                 lm_hi)
        return out[:n]

    # ---- covisibility ----

    def update_connections(self, kf: int, th: int = 15, cap: int = 4096):
        ids = np.empty(cap, np.int32)
        w = np.empty(cap, np.int32)
        parent = ctypes.c_int32(-1)
        n = self._lib.mapcore_update_connections(
            self._h, kf, th, _i32p(ids), _i32p(w), cap,
            ctypes.byref(parent))
        return ids[:n], w[:n], int(parent.value)

    def neighbors(self, kf: int, cap: int = 4096):
        ids = np.empty(cap, np.int32)
        w = np.empty(cap, np.int32)
        n = self._lib.mapcore_neighbors(self._h, kf, _i32p(ids), _i32p(w), cap)
        return ids[:n], w[:n]

    def covis_weight(self, a: int, b: int) -> int:
        return self._lib.mapcore_covis_weight(self._h, a, b)

    def covis_edges(self, cap: int = 1 << 20):
        a = np.empty(cap, np.int32)
        b = np.empty(cap, np.int32)
        w = np.empty(cap, np.int32)
        n = self._lib.mapcore_covis_edges(self._h, _i32p(a), _i32p(b),
                                          _i32p(w), cap)
        return a[:n], b[:n], w[:n]

    # ---- gathers ----

    def local_points(self, tracked, cap: int) -> np.ndarray:
        tracked = _as_i32(tracked)
        out = np.empty(cap, np.int32)
        n = self._lib.mapcore_local_points(
            self._h, _i32p(tracked), len(tracked), _i32p(out), cap)
        return out[:n]

    def local_ba_gather(self, kf: int, max_free: int, max_points: int,
                        max_cams: int):
        cams = np.empty(max_cams, np.int32)
        pnts = np.empty(max_points, np.int32)
        n_free = ctypes.c_int32(0)
        n_pnts = ctypes.c_int32(0)
        n_cams = self._lib.mapcore_local_ba_gather(
            self._h, kf, max_free, max_points, max_cams, _i32p(cams),
            ctypes.byref(n_free), _i32p(pnts), ctypes.byref(n_pnts))
        return cams[:n_cams], int(n_free.value), pnts[: int(n_pnts.value)]

    def assemble_obs(self, cam_ids, pnt_ids, cap: int):
        cam_ids = _as_i32(cam_ids)
        pnt_ids = _as_i32(pnt_ids)
        oc = np.empty(cap, np.int32)
        op = np.empty(cap, np.int32)
        okf = np.empty(cap, np.int32)
        oft = np.empty(cap, np.int32)
        n = self._lib.mapcore_assemble_obs(
            self._h, _i32p(cam_ids), len(cam_ids), _i32p(pnt_ids),
            len(pnt_ids), _i32p(oc), _i32p(op), _i32p(okf), _i32p(oft), cap)
        return oc[:n], op[:n], okf[:n], oft[:n]

    def redundancy(self, kf: int):
        n_pts = ctypes.c_int32(0)
        n_red = ctypes.c_int32(0)
        self._lib.mapcore_redundancy(self._h, kf, ctypes.byref(n_pts),
                                     ctypes.byref(n_red))
        return int(n_pts.value), int(n_red.value)
