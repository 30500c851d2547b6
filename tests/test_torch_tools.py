"""The port's root tools against the repository's ``tools/`` scripts:
``make_kitti_synth`` (a synthetic sequence in the KITTI layout),
``train_vocab`` (the BoW vocabulary from the frontend's descriptors) and
``scaling_report`` (distributed BA on meshes of growing size).

Drawing a synthetic world's 4096-px texture takes ~28 s of one CPU core,
so both tools' ``generate_sequence`` is replaced by a stand-in that
records its arguments and hands out frames of the cached 30-frame
512x160 sequence: the tests hold what the tools themselves do (the
sequence each asks for, the files written, the frontend, the training)
and not the renderer, which ``tests/test_torch_frontend.py`` covers.
Tolerances: KITTI files byte-equal across the tools; keypoints equal and
>= 99.9% of descriptor bits equal between the packages' frontends (the
IC-angle rounding caveat, ROADMAP); trees equal in every integer field;
idf weights within float32 rounding; ``mean_point_err`` within 1e-4 m.
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyorbslam_tpu import config as jcfg_mod
from pyorbslam_tpu.io import synthetic as jsynthetic
from pyorbslam_tpu.io.synthetic import generate_sequence
from pyorbslam_tpu.place import vocabulary as jvocab
from pyorbslam_tpu.slam import frame as jframe

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.io import kitti as tkitti
from pyorbslam_tpu_torch.io.synthetic import SyntheticSequence
from pyorbslam_tpu_torch.place import vocabulary as tvocab
from pyorbslam_tpu_torch.tools import make_kitti_synth, scaling_report, train_vocab

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def root_tool(name: str):
    """The repository's ``tools/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def seq30(data_cache_dir):
    return generate_sequence(
        n_frames=30, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir)


def stand_in(seq30, calls: list):
    """A ``generate_sequence`` that records its keyword arguments and
    returns the next ``n_frames`` frames of ``seq30``."""
    def fake(n_frames, width, height, **kw):
        assert (height, width) == seq30.left.shape[1:]
        first = sum(c["n_frames"] for c in calls)
        calls.append(dict(n_frames=n_frames, **kw))
        part = slice(first, first + n_frames)
        return SyntheticSequence(
            left=seq30.left[part], right=seq30.right[part],
            poses_wc=seq30.poses_wc[part], K=seq30.K,
            baseline=seq30.baseline, timestamps=seq30.timestamps[part])
    return fake


class TestMakeKittiSynth:
    def test_files(self, seq30, tmp_path, monkeypatch, capsys):
        """Both tools write the same bytes from the same sequence, and the
        port's KITTI reader gets the sequence back."""
        port_calls, root_calls = [], []
        monkeypatch.setattr(make_kitti_synth, "generate_sequence",
                            stand_in(seq30, port_calls))
        monkeypatch.setattr(jsynthetic, "generate_sequence",
                            stand_in(seq30, root_calls))
        args = ["--frames", "6", "--width", "512", "--height", "160"]
        make_kitti_synth.main(["--out", str(tmp_path / "port")] + args)
        monkeypatch.setattr(sys, "argv", ["make_kitti_synth.py", "--out",
                                          str(tmp_path / "root")] + args)
        root_tool("make_kitti_synth").main()
        assert "wrote 6 frames" in capsys.readouterr().out
        want = dict(n_frames=6, trajectory="straight", speed=0.8, seed=3)
        assert port_calls == root_calls == [want]

        names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "root")
                       for d, _, fs in os.walk(tmp_path / "root") for f in fs)
        assert len(names) == 2 * 6 + 3
        for name in names:
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "root" / name).read_bytes(), name

        out = str(tmp_path / "port")
        frames = list(tkitti.iter_stereo(out))
        assert len(frames) == 6
        for i, (left, right, ts) in enumerate(frames):
            np.testing.assert_array_equal(left, seq30.left[i])
            np.testing.assert_array_equal(right, seq30.right[i])
            assert ts == pytest.approx(seq30.timestamps[i], abs=1e-6)
        np.testing.assert_allclose(
            tkitti.load_trajectory_kitti(os.path.join(out, "poses.txt")),
            seq30.poses_wc[:6], atol=1e-8)


@pytest.fixture(scope="module")
def vocab_run(seq30, tmp_path_factory):
    """``train_vocab`` at 2 scenes x 3 frames, k = 4, L = 2 on the CPU."""
    calls = []
    out = tmp_path_factory.mktemp("vocab") / "voc.npz"
    mp = pytest.MonkeyPatch()
    mp.setattr(train_vocab, "generate_sequence", stand_in(seq30, calls))
    try:
        voc = train_vocab.main([
            "--scenes", "2", "--frames", "3", "--width", "512", "--height",
            "160", "--features", "1000", "--k", "4", "--L", "2",
            "--device", "cpu", "--out", str(out)])
    finally:
        mp.undo()
    return voc, out, calls


class TestTrainVocab:
    def test_writes_a_vocabulary(self, vocab_run):
        voc, out, calls = vocab_run
        assert [(c["n_frames"], c["trajectory"], c["seed"]) for c in calls] == \
            [(3, "straight", 100), (3, "loop", 101)]
        back = tvocab.load_npz(str(out))
        assert (back.k, back.L, back.n_words) == (4, 2, voc.n_words) and voc.n_words > 4
        for name in ("node_desc", "child_start", "n_children", "word_id", "weight"):
            np.testing.assert_array_equal(getattr(back, name), getattr(voc, name))
        # 16 words over 6 frames: every word is in every document, idf 0
        assert np.isfinite(back.weight).all() and (back.weight >= 0).all()

    def test_corpus_and_tree_against_jax(self, seq30, vocab_run):
        """The corpus: keypoints equal to the JAX frontend's on the same six
        frames, >= 99.9% of descriptor bits equal.  The same corpus trained
        by both packages: equal trees and idf weights."""
        voc, _, _ = vocab_run
        sub = SyntheticSequence(
            left=seq30.left[:6], right=seq30.right[:6], poses_wc=seq30.poses_wc[:6],
            K=seq30.K, baseline=seq30.baseline, timestamps=seq30.timestamps[:6])
        port = train_vocab.frame_features(sub, 1000, CPU)
        jc = jcfg_mod.SlamConfig(
            camera=jcfg_mod.CameraConfig(
                fx=float(seq30.K[0, 0]), fy=float(seq30.K[1, 1]),
                cx=float(seq30.K[0, 2]), cy=float(seq30.K[1, 2]),
                width=512, height=160, bf=seq30.bf, th_depth=40.0),
            orb=jcfg_mod.OrbConfig(n_features=1000))
        bits = same = 0
        for i, (xy, desc) in enumerate(port):
            jf = jframe.build_stereo_frame_jit(
                jnp.asarray(seq30.left[i], jnp.float32),
                jnp.asarray(seq30.right[i], jnp.float32), jc)
            valid = np.asarray(jf.valid)
            np.testing.assert_array_equal(xy, np.asarray(jf.xy)[valid])
            jdesc = np.asarray(jf.desc)[valid]
            diff = np.unpackbits((convert.desc_from_port(desc) ^ jdesc).view(np.uint8))
            bits += diff.size
            same += diff.size - int(diff.sum())
        assert same / bits >= 0.999, same / bits

        tdocs = [d for _, d in port]
        corpus = np.concatenate(tdocs)
        want = tvocab.train(corpus, k=4, L=2, seed=0)
        tvocab.set_idf_weights(want, tdocs)
        for name in ("node_desc", "child_start", "n_children", "word_id", "weight"):
            np.testing.assert_array_equal(getattr(voc, name), getattr(want, name))
        jv = jvocab.train(convert.desc_from_port(corpus), k=4, L=2, seed=0)
        jvocab.set_idf_weights(jv, [convert.desc_from_port(d) for d in tdocs])
        np.testing.assert_array_equal(convert.desc_from_port(voc.node_desc), jv.node_desc)
        for name in ("child_start", "n_children", "word_id"):
            np.testing.assert_array_equal(getattr(voc, name), getattr(jv, name))
        np.testing.assert_allclose(voc.weight, jv.weight, rtol=1e-6)

    def test_refuses_the_jax_package(self, tmp_path):
        """No default ``--out``, and none inside the JAX package: the
        shipped asset is not overwritten."""
        with pytest.raises(SystemExit):
            train_vocab.main(["--scenes", "1", "--device", "cpu"])
        for out in (os.path.join(REPO, "pyorbslam_tpu", "assets", "orb_vocab.npz"),
                    os.path.join(REPO, "tests", "..", "pyorbslam_tpu", "v.npz")):
            with pytest.raises(SystemExit, match="writes nothing under"):
                train_vocab.main(["--device", "cpu", "--out", out])
        assert train_vocab.check_out(str(tmp_path / "v.npz")) == \
            os.path.realpath(tmp_path / "v.npz")


class TestScalingReport:
    def test_against_the_root_tool(self, monkeypatch, capsys):
        args = ["--devices", "1", "2", "--cams", "16", "--points", "2048",
                "--obs-per-cam", "128"]
        port = scaling_report.main(["--cpu"] + args)
        capsys.readouterr()
        for name in ("JAX_PLATFORMS", "XLA_FLAGS"):
            monkeypatch.setenv(name, os.environ.get(name, ""))
        monkeypatch.setattr(sys, "argv", ["scaling_report.py", "--cpu"] + args)
        root_tool("scaling_report").main()
        root = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
        assert [r["devices"] for r in port] == [r["devices"] for r in root] == [1, 2]
        for p, r in zip(port, root):
            assert (p["obs"], p["cams"], p["points"]) == (r["obs"], r["cams"], r["points"])
            assert p["backend"] == "cpu" and p["device"] == "cpu"
            assert abs(p["mean_point_err"] - r["mean_point_err"]) <= 1e-4, (p, r)
        # the noise is 5 cm a coordinate: the solve must take most of it out
        assert all(p["mean_point_err"] < 0.02 for p in port)

    def test_mesh_larger_than_the_cards(self, monkeypatch, capsys):
        """Without --cpu each shard is a card: meshes beyond the cards are
        skipped, and a machine without CUDA refuses to run at all."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            scaling_report.main(["--devices", "1"])
        # one card, here stood in for by the CPU
        monkeypatch.setattr(scaling_report, "device_of", lambda name: CPU)
        monkeypatch.setattr(scaling_report.dist_ba, "make_mesh",
                            lambda: scaling_report.dist_ba.Mesh([CPU]))
        lines = scaling_report.main(["--devices", "1", "2", "--cams", "8",
                                     "--points", "512", "--obs-per-cam", "64"])
        assert lines[0]["devices"] == 1 and lines[0]["mean_point_err"] < 0.05
        assert lines[1] == {"metric": "dist_ba_step_time_s", "devices": 2,
                            "skipped": "not enough devices"}
