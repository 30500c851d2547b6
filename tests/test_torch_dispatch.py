"""The port's dispatches wait for nothing: no read-back and no upload from
pageable memory where the JAX package has none (the per-level extractor's
bounds check, the keyframe side's uploads, a waiting timer in the
pipelined queue).  On the CPU nothing can wait, so these tests check the
calls themselves: which wrapper option the extractor passes, that no
``torch.as_tensor`` / ``torch.tensor`` with a ``device`` argument is left
on the keyframe side and in the ``Tracker``, and which timers of the
pipelined queue may synchronize.  ``chip_smoke.py`` counts the
synchronizing calls on the card.
"""

import dataclasses
import traceback

import numpy as np
import pytest
import torch

from test_torch_mapping import make_cfgs

from pyorbslam_tpu.io.synthetic import generate_sequence

from pyorbslam_tpu_torch.ops import extractor, kernels
from pyorbslam_tpu_torch.slam import system as tsystem
from pyorbslam_tpu_torch.slam.local_mapping import LocalMapper
from pyorbslam_tpu_torch.slam.slam_map import SlamMap
from pyorbslam_tpu_torch.slam.tracking import Tracker

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def seq30(data_cache_dir):
    return generate_sequence(
        n_frames=30, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir)


def test_extractor_skips_the_bounds_check(seq30, monkeypatch):
    """The per-level extractor calls K3's wrapper with
    ``check_bounds=False`` (every keypoint it selects lies inside its
    level), and the words are those of the checked call."""
    calls = []
    real = kernels.brief_descriptors_levels

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(kernels, "brief_descriptors_levels", recording)
    _, tc = make_cfgs(seq30)
    orb = dataclasses.replace(tc.orb, use_atlas=False)
    img = torch.as_tensor(seq30.left[3].astype(np.float32))
    feats = extractor.extract_features(img, orb)
    assert len(calls) == 1
    args, kwargs, out = calls[0]
    assert kwargs == {"check_bounds": False}
    assert torch.equal(out, real(*args, check_bounds=True))
    assert int(feats.valid.sum()) > 500


class _DeviceArgCounter:
    """Counts ``torch.as_tensor`` / ``torch.tensor`` calls given a
    ``device`` while one of the watched methods runs."""

    def __init__(self, monkeypatch):
        self.depth, self.hits, self.entered = 0, [], {}
        for name in ("as_tensor", "tensor"):
            real = getattr(torch, name)
            monkeypatch.setattr(torch, name, self._counted(real, name))

    def _counted(self, real, name):
        def call(*args, **kwargs):
            if self.depth and kwargs.get("device") is not None:
                self.hits.append((name, traceback.format_stack()[-2]))
            return real(*args, **kwargs)
        return call

    def watch(self, monkeypatch, cls, method):
        real = getattr(cls, method)
        key = f"{cls.__name__}.{method}"
        self.entered[key] = 0

        def call(*args, **kwargs):
            self.entered[key] += 1
            self.depth += 1
            try:
                return real(*args, **kwargs)
            finally:
                self.depth -= 1
        monkeypatch.setattr(cls, method, call)


def test_keyframe_side_and_tracker_upload_through_pinned_memory(seq30, monkeypatch):
    """``SlamMap._run_ba``, the ``LocalMapper`` (fused pass and the
    separate-step fallback) and the ``Tracker`` send host arrays through
    ``upload`` / ``device_constant``: no ``torch.as_tensor(...,
    device=)`` or ``torch.tensor(..., device=)`` is left on those paths."""
    counter = _DeviceArgCounter(monkeypatch)
    for cls, method in ((SlamMap, "_run_ba"), (LocalMapper, "maintain_dispatch"),
                        (LocalMapper, "maintain_apply"),
                        (LocalMapper, "create_new_points"),
                        (LocalMapper, "fuse_neighbors"), (Tracker, "track")):
        counter.watch(monkeypatch, cls, method)
    _, tc = make_cfgs(seq30)
    tracker = Tracker(tc, CPU)
    for i in range(3):
        tracker.track(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    s = tsystem.System(tc, CPU, landmark_capacity=1 << 16, keyframe_capacity=64)
    for i in range(10):
        s.track_stereo(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    kf = s.map.keyframes.n - 1
    s.local_mapper.create_new_points(kf)
    s.local_mapper.fuse_neighbors(kf)
    assert all(counter.entered.values()), counter.entered
    assert counter.hits == []


def test_pipelined_queue_timers_do_not_wait(seq30, monkeypatch):
    """In the non-blocking maintenance queue the ring-rotated fallback and
    the loop stage time themselves with ``sync=False``: a waiting timer
    there would also wait for the frame dispatched just before."""
    _, tc = make_cfgs(seq30)
    s = tsystem.System(tc, CPU, landmark_capacity=1 << 16, keyframe_capacity=64)
    for i in range(8):
        s.track_stereo(seq30.left[i], seq30.right[i], seq30.timestamps[i])
    assert s.map.keyframes.n >= 3 and s.loop_closer is not None
    timed = []
    real_t = s._t

    def recording(label, sync=True):
        timed.append((label, sync))
        return real_t(label, sync)

    monkeypatch.setattr(s, "_t", recording)
    monkeypatch.setattr(s.local_mapper, "maintain_dispatch", lambda kf: None)
    kf = s.map.keyframes.n - 1
    it = dict(kf=kf, bow=s.kfdb.bow[kf], stage="new", pend=None, ba_pend=None,
              pre=None)
    s._advance_maint_item(it)
    assert it["stage"] == "maint_done"
    assert ("kf.maintain", False) in timed
    it["stage"] = "post_ba"
    s._advance_maint_item(it)
    assert it["stage"] == "done"
    assert ("kf.loop", False) in timed and ("kf.gba_slice", False) in timed
    assert all(not sync for _, sync in timed)
