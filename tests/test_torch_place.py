"""Parity of the PyTorch port's place-recognition modules (vocabulary,
BoW vectors and scores, keyframe database) with the JAX package.

Descriptors are made from a seed with numpy and go through both packages
on the CPU.  Everything here is integer or a short float sum of the same
terms in the same order, so words, nodes, weights, BoW vectors and
candidate lists must be equal; scores agree to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_place import perturb, random_descriptors

from pyorbslam_tpu.place import vocabulary as jvoc
from pyorbslam_tpu.place.keyframe_db import KeyFrameDatabase as JDatabase

from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.ops import hamming as tham
from pyorbslam_tpu_torch.place import vocabulary as tvoc
from pyorbslam_tpu_torch.place.keyframe_db import KeyFrameDatabase as TDatabase

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)


def words(desc_u32):
    return torch.as_tensor(convert.desc_to_port(desc_u32))


@pytest.fixture(scope="module")
def asset():
    j = jvoc.load_default()
    assert j is not None, "the shipped vocabulary asset is missing"
    return j, tvoc.load_default()


@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(0)
    d = random_descriptors(rng, 3000)
    return (jvoc.train(d, k=10, L=3, seed=1),
            tvoc.train(convert.desc_to_port(d), k=10, L=3, seed=1))


def hard_descriptors(jv, rng, n=600):
    """Random words plus the cases that break a careless port: exact node
    descriptors (distance 0 to one child, ties among siblings likely),
    all-zero and all-one words (many equidistant children), and words
    with the top bit set (negative as int32)."""
    d = random_descriptors(rng, n)
    d[:80] = jv.node_desc[rng.integers(1, len(jv.node_desc), 80)]
    d[80:90] = 0
    d[90:100] = 0xFFFFFFFF
    d[100:200] |= np.uint32(0x80000000)
    return d


class TestTransform:
    def test_asset_loads_by_path(self, asset):
        j, t = asset
        assert (t.k, t.L, t.n_words) == (j.k, j.L, j.n_words)
        assert t.node_desc.dtype == np.int32
        assert np.array_equal(t.node_desc.view(np.uint32), j.node_desc)
        assert t.feature_levels_up == j.feature_levels_up

    @pytest.mark.parametrize("levels_up", [1, 4, 5])
    def test_transform_on_the_asset(self, asset, levels_up):
        j, t = asset
        d = hard_descriptors(j, np.random.default_rng(levels_up))
        jw, jwt, jn = j.transform(jnp.asarray(d), levels_up=levels_up)
        tw, twt, tn = t.transform(words(d), levels_up=levels_up)
        assert np.array_equal(tw, jw) and np.array_equal(tn, jn)
        assert np.array_equal(twt, jwt)           # weights are looked up
        assert tw.dtype == np.int32 and twt.dtype == np.float32

    def test_transform_accepts_numpy_uint32(self, asset):
        j, t = asset
        d = hard_descriptors(j, np.random.default_rng(9), 256)
        a = t.transform(d)
        b = t.transform(words(d))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))

    def test_ties_take_the_lowest_child(self):
        """Two children at the same distance from the query: both packages
        descend into the lower index."""
        node_desc = np.zeros((5, 8), np.uint32)
        node_desc[1, 0] = 0b0011      # child 0: distance 2 from the query
        node_desc[2, 0] = 0b1100      # child 1: distance 2 as well
        node_desc[3, 0] = 0b1111      # child 2: distance 4
        node_desc[4, 7] = 0x80000001  # child 3, top bit set: distance 2
        fields = dict(
            k=4, L=1, child_start=np.array([1, 0, 0, 0, 0], np.int32),
            n_children=np.array([4, 0, 0, 0, 0], np.int32),
            weight=np.array([0, 1, 2, 3, 4], np.float32),
            word_id=np.array([-1, 0, 1, 2, 3], np.int32))
        j = jvoc.Vocabulary(node_desc=node_desc, **fields)
        t = convert.vocabulary_from_numpy(j)
        q = np.zeros((3, 8), np.uint32)
        q[1, 7] = 0x80000001          # distance 0 to child 3
        q[2, 0] = 0b0110              # children 0, 1 and 2 tie at 2
        jw, jwt, jn = j.transform(jnp.asarray(q), levels_up=1)
        tw, twt, tn = t.transform(words(q), levels_up=1)
        assert tw.tolist() == jw.tolist() == [0, 3, 0]
        assert np.array_equal(twt, jwt) and np.array_equal(tn, jn)

    def test_popcount_with_top_bit_words(self):
        rng = np.random.default_rng(4)
        d = random_descriptors(rng, 256) | np.uint32(0x80000000)
        want = np.unpackbits(d.view(np.uint8), axis=1).sum(1)
        assert np.array_equal(tham.popcount(words(d)).numpy(), want)
        a, b = words(d[:128]), words(d[128:])
        want_x = np.unpackbits((d[:128] ^ d[128:]).view(np.uint8), axis=1).sum(1)
        assert np.array_equal(tham.hamming_pairwise(a, b).numpy(), want_x)


class TestKeyframeSnapshot:
    def test_kf_snapshot_equal(self, asset):
        """tracking.kf_snapshot, the one packed read of keyframe insertion
        ([pack_frame 16N | word N | weight bits N | node N]): the same
        frame fields through both packages give the same int32 buffer."""
        from pyorbslam_tpu.slam import frame as jframe
        from pyorbslam_tpu.slam import tracking as jtrack
        from pyorbslam_tpu_torch.slam import tracking as ttrack

        j, t = asset
        rng = np.random.default_rng(21)
        n = 256
        desc = hard_descriptors(j, rng, n)
        fields = dict(
            xy=rng.uniform(0, 500, (n, 2)).astype(np.float32),
            response=rng.uniform(0, 90, n).astype(np.float32),
            angle=rng.uniform(0, 360, n).astype(np.float32),
            octave=rng.integers(0, 8, n).astype(np.int32),
            desc=desc,
            desc_bits=np.unpackbits(desc.view(np.uint8), axis=1,
                                    bitorder="little").astype(np.int8),
            valid=rng.uniform(size=n) > 0.1,
            u_right=rng.uniform(-1, 400, n).astype(np.float32),
            depth=rng.uniform(-1, 60, n).astype(np.float32))
        jf = jframe.StereoFrame(**{k: jnp.asarray(v) for k, v in fields.items()})
        tf = convert.frame_from_numpy(fields, torch.device("cpu"))
        want = np.asarray(jtrack.kf_snapshot(
            jf, j._device_arrays(), j.k, j.L, j.feature_levels_up))
        got = ttrack.kf_snapshot(
            tf, t._device_arrays("cpu"), t.k, t.L, t.feature_levels_up).numpy()
        assert got.dtype == np.int32 and got.shape == (19 * n,)
        assert np.array_equal(got, want)


class TestTrainAndIO:
    def test_train_matches(self, small):
        j, t = small
        assert (t.k, t.L, t.n_words) == (j.k, j.L, j.n_words)
        assert np.array_equal(t.node_desc.view(np.uint32), j.node_desc)
        for f in ("child_start", "n_children", "weight", "word_id"):
            assert np.array_equal(getattr(t, f), getattr(j, f)), f

    def test_set_idf_weights_matches(self):
        rng = np.random.default_rng(11)
        d = random_descriptors(rng, 1500)
        j = jvoc.train(d, k=6, L=3, seed=2)
        t = tvoc.train(convert.desc_to_port(d), k=6, L=3, seed=2)
        docs = [random_descriptors(rng, 200) for _ in range(6)] + [d[:0]]
        jvoc.set_idf_weights(j, docs)
        tvoc.set_idf_weights(t, [convert.desc_to_port(x) for x in docs])
        assert np.array_equal(t.weight, j.weight)
        assert len(np.unique(t.weight)) > 2
        q = random_descriptors(rng, 64)
        assert np.array_equal(t.transform(words(q))[1], j.transform(jnp.asarray(q))[1])

    def test_text_round_trip_across_packages(self, small, tmp_path):
        """Each package reads the other's ORBvoc.txt file to the same tree."""
        j, t = small
        pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
        j.save_text(pj)
        t.save_text(pt)
        assert open(pj).read() == open(pt).read()
        back = tvoc.Vocabulary.load_text(pj)
        jback = jvoc.Vocabulary.load_text(pt)
        assert (back.k, back.L, back.n_words) == (j.k, j.L, j.n_words)
        assert np.array_equal(back.node_desc.view(np.uint32), jback.node_desc)
        for f in ("child_start", "n_children", "weight", "word_id"):
            assert np.array_equal(getattr(back, f), getattr(jback, f)), f
        q = random_descriptors(np.random.default_rng(5), 128)
        w0, _, n0 = t.transform(words(q))
        w1, _, n1 = back.transform(words(q))
        assert np.array_equal(w0, w1) and np.array_equal(n0, n1)

    def test_npz_round_trip(self, small, tmp_path):
        _, t = small
        path = str(tmp_path / "voc.npz")
        tvoc.save_npz(t, path)
        back = tvoc.load_npz(path)
        assert back.node_desc.dtype == np.int32 and back.n_words == t.n_words
        assert np.array_equal(back.node_desc, t.node_desc)
        # and the JAX package's loader reads the same bits
        assert np.array_equal(jvoc.load_npz(path).node_desc.view(np.int32),
                              t.node_desc)

    def test_vocabulary_from_numpy(self, small):
        j, t = small
        c = convert.vocabulary_from_numpy(j)
        assert np.array_equal(c.node_desc, t.node_desc) and c.n_words == j.n_words
        q = random_descriptors(np.random.default_rng(6), 32)
        assert np.array_equal(c.transform(words(q))[0], j.transform(jnp.asarray(q))[0])


class TestBow:
    def _bows(self, small, seed, n=300):
        j, t = small
        rng = np.random.default_rng(seed)
        d = random_descriptors(rng, n)
        valid = rng.uniform(size=n) > 0.2
        jw, jwt, _ = j.transform(jnp.asarray(d))
        tw, twt, _ = t.transform(words(d))
        return (j.bow_vector(jw, jwt, valid), t.bow_vector(tw, twt, valid),
                j.bow_vector(jw, jwt), t.bow_vector(tw, twt))

    def test_bow_vector_equal(self, small):
        jb, tb, jb_all, tb_all = self._bows(small, 5)
        assert jb == tb and jb_all == tb_all
        assert abs(sum(tb.values()) - 1.0) < 1e-9 and len(tb) < len(tb_all)

    def test_score_equal(self, small):
        a = self._bows(small, 5)
        b = self._bows(small, 6)
        assert tvoc.Vocabulary.score(a[1], b[1]) == pytest.approx(
            jvoc.Vocabulary.score(a[0], b[0]), abs=1e-12)
        assert tvoc.Vocabulary.score(a[1], a[1]) == pytest.approx(1.0, abs=1e-6)


class TestKeyFrameDatabase:
    def _fill(self, small):
        j, t = small
        rng = np.random.default_rng(7)
        base = random_descriptors(rng, 300)
        jdb, tdb = JDatabase(j), TDatabase(t)
        for kf in range(8):
            d = (perturb(rng, base, bits=8) if kf in (3, 5)
                 else random_descriptors(rng, 300))
            jw, jwt, _ = j.transform(jnp.asarray(d))
            tw, twt, _ = t.transform(words(d))
            jdb.add(kf, j.bow_vector(jw, jwt))
            tdb.add(kf, t.bow_vector(tw, twt))
        q = perturb(rng, base, bits=4)
        jw, jwt, _ = j.transform(jnp.asarray(q))
        tw, twt, _ = t.transform(words(q))
        return jdb, tdb, j.bow_vector(jw, jwt), t.bow_vector(tw, twt)

    def test_candidates_equal(self, small):
        jdb, tdb, jq, tq = self._fill(small)
        neighbors = lambda k, n: [5] if k == 3 else []  # noqa: E731
        want = jdb.detect_loop_candidates(99, jq, 0.01, set(), neighbors)
        got = tdb.detect_loop_candidates(99, tq, 0.01, set(), neighbors)
        assert got == want and 5 in got
        assert (tdb.detect_relocalization_candidates(tq, neighbors)
                == jdb.detect_relocalization_candidates(jq, neighbors))
        assert (tdb.detect_loop_candidates(99, tq, 0.01, {5}, neighbors)
                == jdb.detect_loop_candidates(99, jq, 0.01, {5}, neighbors))

    def test_erase_and_clear(self, small):
        _, tdb, _, tq = self._fill(small)
        for kf in (3, 5):
            tdb.erase(kf)
        assert 5 not in tdb.detect_relocalization_candidates(tq, lambda k, n: [])
        tdb.erase(5)                      # erasing twice is a no-op
        tdb.clear()
        assert tdb.detect_relocalization_candidates(tq, lambda k, n: []) == []
