"""Parity of the PyTorch port's per-frame frontend with the JAX package.

The same numpy inputs go through the JAX function (on the CPU, as the
JAX package's own tests run it) and through the port's function on the
CPU, where every hand kernel's wrapper runs its plain twin.  Tolerances
are stated per test with their reason.
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyorbslam_tpu import config as jcfg_mod
from pyorbslam_tpu.geometry import se3 as jse3
from pyorbslam_tpu.io import synthetic as jsyn
from pyorbslam_tpu.ops import atlas as jatlas
from pyorbslam_tpu.ops import extractor as jext
from pyorbslam_tpu.ops import fast as jfast
from pyorbslam_tpu.ops import hamming as jham
from pyorbslam_tpu.ops import orb_descriptor as jdesc
from pyorbslam_tpu.ops import pyramid as jpyr
from pyorbslam_tpu.ops import stereo as jstereo
from pyorbslam_tpu.ops.pallas_kernels import (
    brief_descriptors_canvas as pallas_brief_canvas,
    brief_descriptors_pallas,
    fast_score_map_pallas,
)
from pyorbslam_tpu.slam import frame as jframe

from pyorbslam_tpu_torch import config as tcfg_mod
from pyorbslam_tpu_torch import convert
from pyorbslam_tpu_torch.geometry import se3 as tse3
from pyorbslam_tpu_torch.io import synthetic as tsyn
from pyorbslam_tpu_torch.ops import atlas as tatlas
from pyorbslam_tpu_torch.ops import extractor as text
from pyorbslam_tpu_torch.ops import fast as tfast
from pyorbslam_tpu_torch.ops import hamming as tham
from pyorbslam_tpu_torch.ops import kernels
from pyorbslam_tpu_torch.ops import orb_descriptor as tdesc
from pyorbslam_tpu_torch.ops import pyramid as tpyr
from pyorbslam_tpu_torch.ops import stereo as tstereo
from pyorbslam_tpu_torch.slam import frame as tframe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)


def T(a):
    return torch.as_tensor(np.array(a, order="C"))


def N(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def bit_agreement(a_u32: np.ndarray, b_u32: np.ndarray) -> float:
    diff = np.unpackbits((a_u32 ^ b_u32).view(np.uint8)).sum()
    return 1.0 - diff / (a_u32.size * 32)


@pytest.fixture(scope="module")
def cfgs(synth_seq):
    seq = synth_seq
    jc = jcfg_mod.SlamConfig(
        camera=jcfg_mod.CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=seq.left.shape[2], height=seq.left.shape[1],
            bf=seq.bf, th_depth=40.0,
        ),
        orb=jcfg_mod.OrbConfig(n_features=1000),
    )
    return jc, convert.config_from_dict(convert.config_to_dict(jc))


@pytest.fixture(scope="module")
def stereo_pair(synth_seq):
    return (synth_seq.left[0].astype(np.float32),
            synth_seq.right[0].astype(np.float32))


@pytest.fixture(scope="module")
def canvas(stereo_pair, cfgs):
    """The frame's atlas canvas (the port's; equal to the JAX one, see
    test_canvas_matches)."""
    orb = cfgs[1].orb
    l, r = stereo_pair
    lay = tatlas.atlas_layout(l.shape[0], l.shape[1], orb.scale_factor,
                              orb.n_levels, orb.cell_size, orb.bucket_size,
                              orb.per_bucket_cap)
    return tatlas.assemble_canvas(
        lay, tpyr.build_pyramid(T(l), orb.scale_factor, orb.n_levels),
        tpyr.build_pyramid(T(r), orb.scale_factor, orb.n_levels))


@pytest.fixture(scope="module")
def atlas_features(stereo_pair, cfgs):
    """Both packages' atlas extraction of the frame.  The JAX side runs
    jitted with the (bit-equal, see test_pyramid_levels) eager pyramids
    passed in, as build_stereo_frame passes its own."""
    jc, tc = cfgs
    l, r = stereo_pair
    jl = jpyr.build_pyramid(jnp.asarray(l), jc.orb.scale_factor, jc.orb.n_levels)
    jr = jpyr.build_pyramid(jnp.asarray(r), jc.orb.scale_factor, jc.orb.n_levels)
    jit_atlas = jax.jit(lambda a, b, la, lb: jatlas.extract_features_atlas(
        a, b, jc.orb, levels_l=la, levels_r=lb))
    jf = jit_atlas(jnp.asarray(l), jnp.asarray(r), jl, jr)
    tf = tatlas.extract_features_atlas(T(l), T(r), tc.orb)
    return jf, tf


@pytest.fixture(scope="module")
def frames(stereo_pair, cfgs):
    jc, tc = cfgs
    l, r = stereo_pair
    jf = jframe.build_stereo_frame_jit(jnp.asarray(l), jnp.asarray(r), jc)
    tf = tframe.build_stereo_frame(T(l), T(r), tc)
    return jf, tf


class TestConfig:
    @pytest.mark.parametrize(
        "path", sorted(glob.glob(os.path.join(REPO, "configs", "KITTI*.yaml"))),
        ids=os.path.basename)
    def test_from_yaml_field_for_field(self, path):
        jc = jcfg_mod.SlamConfig.from_yaml(path)
        tc = tcfg_mod.SlamConfig.from_yaml(path)
        assert convert.config_to_dict(jc) == convert.config_to_dict(tc)
        for prop in ("scale_factors", "level_sigma2", "inv_level_sigma2",
                     "features_per_level"):
            a, b = getattr(jc.orb, prop), getattr(tc.orb, prop)
            assert a.dtype == b.dtype and np.array_equal(a, b), prop
        assert jc.orb.max_keypoints == tc.orb.max_keypoints
        assert jc.camera.baseline == tc.camera.baseline
        assert jc.camera.depth_threshold == tc.camera.depth_threshold
        np.testing.assert_array_equal(jc.camera.K, tc.camera.K)
        # and the conversion round-trips
        assert convert.config_from_dict(convert.config_to_dict(jc)) == tc


class TestPyramid:
    def test_pyramid_levels(self, stereo_pair):
        """atol 1e-4 against the eager JAX pyramid (as tests/test_frontend.py
        runs it), which in fact agrees bit for bit.  Jitted, XLA:CPU
        contracts the bilinear a + f*(b-a) into FMAs, and over 7 chained
        levels that drifts by a few float32 ulps: rtol 4e-6 there."""
        img = stereo_pair[0]
        got = tpyr.build_pyramid(T(img), 1.2, 8)
        eager = jpyr.build_pyramid(jnp.asarray(img), 1.2, 8)
        jitted = jax.jit(jpyr.build_pyramid, static_argnums=(1, 2))(
            jnp.asarray(img), 1.2, 8)
        assert [tuple(g.shape) for g in got] == [a.shape for a in eager]
        for a, j, g in zip(eager, jitted, got):
            np.testing.assert_allclose(N(g), np.asarray(a), atol=1e-4, rtol=0)
            np.testing.assert_array_equal(N(g), np.asarray(a))
            np.testing.assert_allclose(N(g), np.asarray(j), rtol=4e-6, atol=0)

    def test_canvas_matches(self, stereo_pair, canvas):
        l, r = stereo_pair
        lay = jatlas.atlas_layout(l.shape[0], l.shape[1], 1.2, 8, 32, 16, 4)
        ref = jatlas.assemble_canvas(
            lay, jpyr.build_pyramid(jnp.asarray(l), 1.2, 8),
            jpyr.build_pyramid(jnp.asarray(r), 1.2, 8))
        np.testing.assert_array_equal(N(canvas), np.asarray(ref))
        tl = tatlas.atlas_layout(l.shape[0], l.shape[1], 1.2, 8, 32, 16, 4)
        assert tl.tiles == lay.tiles and tl.shift == lay.shift
        np.testing.assert_array_equal(tl.cand_idx, lay.cand_idx)
        np.testing.assert_array_equal(tl.interior16, lay.interior16)

    def test_u8_blur(self, canvas):
        """Equal on >= 99.99% of pixels: the only source of difference is
        FMA contraction of the seven shifted adds in jitted XLA:CPU, which
        can move a value across a .5 rounding boundary."""
        ref = np.asarray(jax.jit(lambda c: jnp.round(jpyr.gaussian_blur(c)))(
            jnp.asarray(N(canvas))))
        got = N(torch.round(tpyr.gaussian_blur(canvas)))
        assert (ref == got).mean() >= 0.9999
        eager = np.asarray(jnp.round(jpyr.gaussian_blur(jnp.asarray(N(canvas)))))
        assert (eager == got).mean() >= 0.9999


class TestFastTwin:
    def test_equals_jax_fast_everywhere(self, canvas):
        """K1's twin: min/max of exact differences, atol 0 on every pixel."""
        ref = np.asarray(jax.jit(jfast.fast_score_map)(jnp.asarray(N(canvas))))
        np.testing.assert_array_equal(N(tfast.fast_score_map(canvas)), ref)

    @pytest.mark.parametrize("shape", [(200, 300), (97, 211)])
    def test_equals_pallas_interpret_inside_border(self, shape):
        """As tests/test_pallas.py runs the Pallas kernel: the column
        border differs by design (the TPU kernel wraps columns)."""
        img = jsyn.make_texture(512, seed=3)[: shape[0], : shape[1]]
        ref = np.asarray(fast_score_map_pallas(jnp.asarray(img), interpret=True))
        got = N(kernels.fast_score_map(T(img)))
        b = 4
        np.testing.assert_allclose(got[b:-b, b:-b], ref[b:-b, b:-b], atol=1e-5)

    @pytest.mark.parametrize("shape", [(1, 50), (5, 7), (31, 40), (32, 33),
                                       (33, 9), (64, 65), (97, 211)])
    def test_row_blocks_equal_the_whole_image(self, shape):
        """On the CPU the twin runs in blocks of rows; every block sees its
        neighbours' rows as the whole image does, so the scores are the
        same to the bit, at every block edge and on a short last block."""
        img = T(np.random.default_rng(5).uniform(0, 255, shape).astype(np.float32))
        pad = torch.nn.functional.pad(img[None, None], (3, 3, 3, 3),
                                      mode="replicate")[0, 0]
        whole = tfast._fast_block(pad, *shape)
        assert torch.equal(tfast.fast_score_map(img), whole)


def _jax_gather_branch(blur, cxy, ang):
    """The JAX package's CPU descriptor branch, atlas.py:296-307."""
    pat = jnp.asarray(jdesc.brief_pattern(), jnp.float32)
    rad = jnp.radians(ang)
    a = jnp.cos(rad)[:, None]
    b_ = jnp.sin(rad)[:, None]
    px, py = pat[None, :, 0], pat[None, :, 1]
    rows = jnp.round(px * b_ + py * a).astype(jnp.int32)
    cols = jnp.round(px * a - py * b_).astype(jnp.int32)
    samp = jdesc.gather_patches(blur, cxy, rows, cols, border=0)
    bits = (samp[:, 0::2] < samp[:, 1::2]).astype(jnp.uint32)
    words = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


class TestBriefTwin:
    def test_bit_exact_against_gather_branch_and_pallas(self):
        """K2's twin against both JAX forms on a u8-valued canvas with 96
        keypoints at random angles (the JAX package's first test of its
        canvas kernel): every word equal."""
        rng = np.random.default_rng(7)
        blur = rng.integers(0, 256, (200, 400)).astype(np.float32)
        n = 96
        xy = np.stack([rng.integers(19, 400 - 19, n),
                       rng.integers(19, 200 - 19, n)], 1).astype(np.int32)
        xy[:4] = [[19, 19], [400 - 20, 19], [19, 200 - 20], [400 - 20, 200 - 20]]
        ang = rng.uniform(0.0, 360.0, n).astype(np.float32)
        got = convert.desc_from_port(N(kernels.brief_descriptors_canvas(
            T(blur), T(xy), T(ang))))
        gather = np.asarray(jax.jit(_jax_gather_branch)(
            jnp.asarray(blur), jnp.asarray(xy), jnp.asarray(ang)))
        pallas = np.asarray(pallas_brief_canvas(
            jnp.asarray(blur), jnp.asarray(xy), jnp.asarray(ang), interpret=True))
        np.testing.assert_array_equal(got, gather)
        np.testing.assert_array_equal(got, pallas)

    def test_per_level_descriptor_twin(self):
        """brief_descriptors on a reflect-padded level (K3's plain form):
        bit-exact for the same angles on a u8-valued image."""
        rng = np.random.default_rng(2)
        img = rng.integers(0, 256, (120, 200)).astype(np.float32)
        xy = np.stack([rng.integers(0, 200, 80), rng.integers(0, 120, 80)],
                      1).astype(np.int32)
        ang = rng.uniform(0.0, 360.0, 80).astype(np.float32)
        ref = np.asarray(jdesc.brief_descriptors(
            jpyr.reflect_pad(jnp.asarray(img), 19), jnp.asarray(xy), jnp.asarray(ang)))
        got = tdesc.brief_descriptors(tpyr.reflect_pad(T(img), 19), T(xy), T(ang))
        np.testing.assert_array_equal(convert.desc_from_port(N(got)), ref)


    @pytest.mark.parametrize("values", ["float", "u8"])
    def test_level_wrapper_equals_jax_and_pallas(self, values):
        """K3's wrapper on the CPU (its twin) against the function the JAX
        per-level extractor calls, and against the TPU kernel it replaces
        run in interpret mode, on a blurred level that is NOT rounded to
        u8 ("float") and on a u8-valued one: every word equal given the
        same angles.  Keypoints lie >= 16 px inside the level, where the
        extractor puts them (DETECT_BORDER); the Pallas kernel's aligned
        window start goes negative for a keypoint within 3 px of the top
        edge and its words are then wrong, which the extractor never
        asks of it."""
        rng = np.random.default_rng(12)
        img = rng.uniform(0.0, 255.0, (120, 200)).astype(np.float32)
        if values == "u8":
            img = np.round(img)
        n = 64
        xy = np.stack([rng.integers(16, 200 - 16, n),
                       rng.integers(16, 120 - 16, n)], 1).astype(np.int32)
        xy[:4] = [[16, 16], [200 - 17, 16], [16, 120 - 17], [200 - 17, 120 - 17]]
        ang = rng.uniform(0.0, 360.0, n).astype(np.float32)
        ang[:4] = [0.0, 90.0, 180.0, 359.99]
        padded = jpyr.reflect_pad(jnp.asarray(img), 19)
        got = convert.desc_from_port(N(kernels.brief_descriptors_level(
            tpyr.reflect_pad(T(img), 19), T(xy), T(ang))))
        ref = np.asarray(jdesc.brief_descriptors(
            padded, jnp.asarray(xy), jnp.asarray(ang)))
        pallas = np.asarray(brief_descriptors_pallas(
            padded, jnp.asarray(xy), jnp.asarray(ang), interpret=True))
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, pallas)
        assert kernels.BRIEF_LEVEL.launches == 0

    def test_level_wrapper_takes_border_keypoints(self):
        """Any pixel of the level is a legal keypoint for the wrapper (the
        pad is 19, the pattern reaches 19): invalid slots of
        select_keypoints sit at the level's first pixels."""
        rng = np.random.default_rng(13)
        img = rng.uniform(0.0, 255.0, (60, 90)).astype(np.float32)
        xy = np.array([[0, 0], [89, 0], [0, 59], [89, 59], [1, 0]], np.int32)
        ang = rng.uniform(0.0, 360.0, 5).astype(np.float32)
        got = convert.desc_from_port(N(kernels.brief_descriptors_level(
            tpyr.reflect_pad(T(img), 19), T(xy), T(ang))))
        ref = np.asarray(jdesc.brief_descriptors(
            jpyr.reflect_pad(jnp.asarray(img), 19), jnp.asarray(xy),
            jnp.asarray(ang)))
        np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def three_levels():
    """A 3-level pyramid of a 160x96 texture crop with 64 keypoints and
    angles a level (numpy seed), as numpy arrays: level images, blurred
    reflect-padded level images (the port's, bit-equal to the JAX
    package's eager ones, see test_pyramid_levels), xy, angles."""
    rng = np.random.default_rng(31)
    img = jsyn.make_texture(512, seed=5)[:96, :160]
    levels = [N(l) for l in tpyr.build_pyramid(T(img), 1.2, 3)]
    padded = [N(tpyr.reflect_pad(tpyr.gaussian_blur(T(l)), 19)) for l in levels]
    xy = [np.stack([rng.integers(16, l.shape[1] - 16, 64),
                    rng.integers(16, l.shape[0] - 16, 64)], 1).astype(np.int32)
          for l in levels]
    ang = [rng.uniform(0.0, 360.0, 64).astype(np.float32) for _ in levels]
    return levels, padded, xy, ang


class TestMultiImageWrappers:
    """The one-call-a-frame entry points on the CPU (their twins) against
    the JAX package's function per level."""

    def test_fast_score_maps_equals_jax_per_level(self, three_levels):
        """max |diff| 0 on every pixel against the eager JAX function; the
        Pallas kernel in interpret mode, as tests/test_pallas.py runs it,
        outside the column border it documents."""
        levels = three_levels[0]
        got = kernels.fast_score_maps([T(l) for l in levels])
        assert len(got) == len(levels)
        for g, l in zip(got, levels):
            np.testing.assert_array_equal(
                N(g), np.asarray(jfast.fast_score_map(jnp.asarray(l))))
            ref = np.asarray(fast_score_map_pallas(jnp.asarray(l), interpret=True))
            b = 4
            np.testing.assert_allclose(N(g)[b:-b, b:-b], ref[b:-b, b:-b], atol=1e-5)
        assert kernels.FAST_SCORE.launches == 0

    def test_brief_levels_ref_equals_jax_per_level(self, three_levels):
        """Every word equal given the same angles, per level and in the
        order given, through the twin and through the wrapper."""
        _, padded, xy, ang = three_levels
        args = ([T(p) for p in padded], [T(k) for k in xy], [T(a) for a in ang])
        ref = np.concatenate([
            np.asarray(jdesc.brief_descriptors(jnp.asarray(p), jnp.asarray(k),
                                               jnp.asarray(a)))
            for p, k, a in zip(padded, xy, ang)])
        for fn in (kernels.brief_descriptors_levels_ref,
                   kernels.brief_descriptors_levels):
            np.testing.assert_array_equal(convert.desc_from_port(N(fn(*args))), ref)
        assert kernels.BRIEF_LEVEL.launches == 0


def _extract_loop_per_level(img, orb, levels=None):
    """The per-level extractor as a loop with one score call and one
    descriptor call a level (the form before the calls were gathered)."""
    if levels is None:
        levels = tpyr.build_pyramid(img, orb.scale_factor, orb.n_levels)
    cols = [[] for _ in range(6)]
    for l, level_img in enumerate(levels):
        level_img = level_img.contiguous()
        score = tfast.border_mask(tfast.fast_score_map(level_img), text.DETECT_BORDER)
        score = tfast.cell_fallback_mask(score, float(orb.ini_th_fast),
                                         float(orb.min_th_fast), orb.cell_size)
        xy, resp, valid = tfast.select_keypoints(
            tfast.nms3x3(score), int(orb.features_per_level[l]), orb.bucket_size,
            orb.per_bucket_cap)
        m10, m01 = tdesc.moment_maps(tpyr.reflect_pad(level_img, tdesc.BORDER))
        ang = tdesc.ic_angle_from_maps(m10, m01, xy)
        padded_blur = tpyr.reflect_pad(tpyr.gaussian_blur(level_img), tdesc.BORDER)
        d = tdesc.brief_descriptors(padded_blur.contiguous(), xy, ang)
        s = torch.tensor(float(orb.scale_factors[l]), dtype=torch.float32)
        for col, v in zip(cols, (xy.to(torch.float32) * s, resp, ang,
                                 torch.full((xy.shape[0],), l, dtype=torch.int32),
                                 d, valid)):
            col.append(v)
    cap = orb.max_keypoints
    return text.FrameFeatures(*(text._pad_axis0(torch.cat(c), cap) for c in cols))


class TestPerLevelCallStructure:
    @pytest.fixture(scope="class")
    def pair(self):
        img = tsyn.make_texture(512, seed=7)[:200, :320]
        return T(img), T(np.roll(img, -5, axis=1).copy())

    @pytest.mark.parametrize("n_levels", [4, 9])
    def test_extract_features_equals_the_loop(self, pair, n_levels):
        """Field for field (torch.equal): gathering the calls changes no
        result.  9 levels do not fit the stereo call's 16-image table; each
        image then takes its own calls, with the same result."""
        left, right = pair
        orb = tcfg_mod.OrbConfig(n_features=600, n_levels=n_levels, use_atlas=False)
        want_l = _extract_loop_per_level(left, orb)
        want_r = _extract_loop_per_level(right, orb)
        got_l = text.extract_features(left, orb)
        stereo_l, stereo_r = text.extract_features_stereo(left, right, orb)
        assert int(want_l.valid.sum()) > 200
        for got, want in ((got_l, want_l), (stereo_l, want_l), (stereo_r, want_r)):
            assert got.capacity == orb.max_keypoints
            for name in text.FrameFeatures._fields:
                a, b = getattr(got, name), getattr(want, name)
                assert a.dtype == b.dtype and torch.equal(a, b), name

    def test_shared_pyramids_are_used(self, pair):
        left, right = pair
        orb = tcfg_mod.OrbConfig(n_features=600, n_levels=4, use_atlas=False)
        ll = tpyr.build_pyramid(left, orb.scale_factor, orb.n_levels)
        lr = tpyr.build_pyramid(right, orb.scale_factor, orb.n_levels)
        a = text.extract_features_stereo(left, right, orb, levels_l=ll, levels_r=lr)
        b = text.extract_features_stereo(left, right, orb)
        for fa, fb in zip(a, b):
            for name in text.FrameFeatures._fields:
                assert torch.equal(getattr(fa, name), getattr(fb, name)), name
        single = text.extract_features(right, orb, levels=lr)
        assert torch.equal(single.desc, b[1].desc)

    def test_build_stereo_frame_per_level(self, stereo_pair, cfgs):
        """The slice as a whole with use_atlas=False on the cached frame,
        each package end to end: same keypoints, descriptor bits of the
        valid slots >= 99.9% (IC angles, see test_ic_angles_at; an invalid
        slot sits on a flat corner pixel of its level, where the angle is
        arbitrary and nothing reads the words), same matched set but for the
        few features whose differing bits move them across the matcher's
        distance threshold (>= 99%)."""
        jc, tc = cfgs
        jc = dataclasses.replace(jc, orb=dataclasses.replace(jc.orb, use_atlas=False))
        tc = dataclasses.replace(tc, orb=dataclasses.replace(tc.orb, use_atlas=False))
        l, r = stereo_pair
        jf = jframe.build_stereo_frame_jit(jnp.asarray(l), jnp.asarray(r), jc)
        ref = {k: np.asarray(v) for k, v in jf._asdict().items()}
        got = convert.frame_to_numpy(tframe.build_stereo_frame(T(l), T(r), tc))
        for name in ("xy", "octave", "valid"):
            np.testing.assert_array_equal(got[name], ref[name], name)
        v = got["valid"]
        assert int(v.sum()) > 500
        assert bit_agreement(ref["desc"][v], got["desc"][v]) >= 0.999
        m = ref["depth"] > 0
        assert m.sum() > 300
        assert ((got["depth"] > 0) == m).mean() >= 0.99
        assert kernels.launch_counts() == {
            "fast_score": 0, "brief_canvas": 0, "brief_level": 0}


class TestOrientation:
    def test_ic_angles_at(self, canvas, cfgs):
        """At the frame's own keypoints.  The moments are row cumulative
        sums: torch's CPU cumsum accumulates in double, XLA:CPU's float32
        cumsum rounds otherwise, by a few units where cumsum(col * I)
        passes 2^24, which moves a corner's angle by up to ~0.2 degree."""
        orb = cfgs[1].orb
        c = N(canvas)
        lay = tatlas.atlas_layout(160, 512, orb.scale_factor, orb.n_levels,
                                  orb.cell_size, orb.bucket_size, orb.per_bucket_cap)
        score = N(tfast.nms3x3(tfast.fast_score_map(canvas) * T(lay.interior16)))
        ys, xs = np.nonzero(score > 7.0)
        xy = np.stack([xs, ys], 1).astype(np.int32)
        assert len(xy) > 500
        ref = np.asarray(jdesc.ic_angles_at(jnp.asarray(c), jnp.asarray(xy)))
        got = N(tdesc.ic_angles_at(canvas, T(xy)))
        d = np.abs((got - ref + 180.0) % 360.0 - 180.0)
        assert d.max() < 0.5 and np.median(d) < 0.01

    def test_ic_angle_patch_form(self):
        """``ic_angle``, the reference's per-keypoint patch form
        (``tests/test_frontend.py``, ``tests/test_moment_maps.py``), on the
        same unblurred padded level and keypoints: the moments are sums of
        integers below 2^24, exact in float32 in any order, so the angles
        agree to the last rounding of atan2."""
        img = jsyn.make_texture(512, seed=9)[:240, :320].astype(np.float32)
        rng = np.random.default_rng(0)
        xy = np.stack([rng.integers(20, 300, 200), rng.integers(20, 220, 200)],
                      1).astype(np.int32)
        want = np.asarray(jdesc.ic_angle(jpyr.reflect_pad(jnp.asarray(img), 19),
                                         jnp.asarray(xy)))
        got = N(tdesc.ic_angle(tpyr.reflect_pad(T(img), 19), T(xy)))
        assert got.shape == want.shape == (200,)
        d = np.abs((got - want + 180.0) % 360.0 - 180.0)
        assert d.max() < 1e-3, d.max()

    def test_moment_maps(self):
        """Moment maps to 8 units (the float32 rounding of cumulative sums
        near 5e6 is 0.25-0.5 per add); angles read from them agree within
        0.1 degree at >= 99% of interior points (the rest sit where the
        moments nearly vanish and the angle is undefined)."""
        img = jsyn.make_texture(512, seed=9)[:120, :160]
        padded = jpyr.reflect_pad(jnp.asarray(img), 19)
        m10, m01 = jdesc.moment_maps(padded)
        t10, t01 = tdesc.moment_maps(tpyr.reflect_pad(T(img), 19))
        for ref, got in ((m10, t10), (m01, t01)):
            np.testing.assert_allclose(N(got), np.asarray(ref), rtol=0, atol=8.0)
        rng = np.random.default_rng(0)
        xy = np.stack([rng.integers(16, 144, 300), rng.integers(16, 104, 300)],
                      1).astype(np.int32)
        a = np.asarray(jdesc.ic_angle_from_maps(m10, m01, jnp.asarray(xy)))
        b = N(tdesc.ic_angle_from_maps(t10, t01, T(xy)))
        assert (np.abs((a - b + 180.0) % 360.0 - 180.0) < 0.1).mean() >= 0.99


class TestSelection:
    def _tied_scores(self, h=96, w=130):
        """Integer FAST-like scores with many exact ties."""
        rng = np.random.default_rng(11)
        s = rng.integers(0, 6, (h, w)).astype(np.float32) * 5.0
        s[rng.random((h, w)) < 0.5] = 0.0
        return s

    def test_topk_ties_match_lax_top_k(self):
        s = self._tied_scores()
        flat = s.reshape(12, -1)
        jv, ji = jax.lax.top_k(jnp.asarray(flat), 37)
        tv, ti = tfast.topk_stable(T(flat), 37)
        np.testing.assert_array_equal(N(tv), np.asarray(jv))
        np.testing.assert_array_equal(N(ti), np.asarray(ji))

    def test_select_keypoints_with_ties(self):
        s = self._tied_scores()
        for n_keep in (50, 333):
            ref = jfast.select_keypoints(jnp.asarray(s), n_keep, 16, 4)
            got = tfast.select_keypoints(T(s), n_keep, 16, 4)
            for a, b in zip(ref, got):
                np.testing.assert_array_equal(N(b), np.asarray(a))

    def test_bucket_candidates_and_masks_with_ties(self):
        s = self._tied_scores()
        for shift in (0, 13):
            jv, jp = jatlas._bucket_candidates(jnp.asarray(s), 16, 4, shift)
            tv, tp = tatlas._bucket_candidates(T(s), 16, 4, shift)
            np.testing.assert_array_equal(N(tv), np.asarray(jv))
            np.testing.assert_array_equal(N(tp), np.asarray(jp))
        np.testing.assert_array_equal(
            N(tfast.nms3x3(T(s))), np.asarray(jfast.nms3x3(jnp.asarray(s))))
        np.testing.assert_array_equal(
            N(tatlas._cell_fallback_shifted(T(s), 20.0, 7.0, 32, 13)),
            np.asarray(jatlas._cell_fallback_shifted(jnp.asarray(s), 20.0, 7.0, 32, 13)))
        np.testing.assert_array_equal(
            N(tfast.border_mask(T(s), 16)),
            np.asarray(jfast.border_mask(jnp.asarray(s), 16)))


class TestExtraction:
    def test_atlas_keypoints_identical(self, atlas_features):
        """Identical keypoint sets (xy, octave, valid, response, in order)."""
        jf, tf = atlas_features
        for j, t in zip(jf, tf):
            for name in ("xy", "octave", "valid", "response"):
                np.testing.assert_array_equal(N(getattr(t, name)),
                                              np.asarray(getattr(j, name)), name)

    def test_atlas_descriptors(self, atlas_features):
        """>= 99.9% of descriptor bits agree.  The differing bits come from
        IC angles (see test_ic_angles_at) that moved a rotated pattern
        offset across a .5 rounding boundary; with equal angles the
        descriptor twin is bit-exact (TestBriefTwin)."""
        jf, tf = atlas_features
        for j, t in zip(jf, tf):
            ref = np.asarray(j.desc)
            got = convert.desc_from_port(N(t.desc))
            assert bit_agreement(ref, got) >= 0.999
            d = np.abs((N(t.angle) - np.asarray(j.angle) + 180) % 360 - 180)
            assert d.max() < 0.5
            same = (got == ref).all(axis=1)
            assert same.mean() >= 0.95

    def test_per_level_extractor(self):
        """The use_atlas=False path on a 200x320 image, 4 levels."""
        img = jsyn.make_texture(512, seed=7)[:200, :320]
        jorb = jcfg_mod.OrbConfig(n_features=600, n_levels=4, use_atlas=False)
        torb = tcfg_mod.OrbConfig(n_features=600, n_levels=4, use_atlas=False)
        ref = jext.extract_features_jit(jnp.asarray(img), jorb)
        got = text.extract_features(T(img), torb)
        assert got.capacity == ref.capacity == torb.max_keypoints
        for name in ("xy", "octave", "valid", "response"):
            np.testing.assert_allclose(N(getattr(got, name)),
                                       np.asarray(getattr(ref, name)), atol=1e-4)
        assert bit_agreement(np.asarray(ref.desc),
                             convert.desc_from_port(N(got.desc))) >= 0.999


class TestHamming:
    def test_hamming_exact(self):
        rng = np.random.default_rng(5)
        a = rng.integers(0, 2 ** 32, (70, 8), dtype=np.uint64).astype(np.uint32)
        b = rng.integers(0, 2 ** 32, (90, 8), dtype=np.uint64).astype(np.uint32)
        a[0] = 0xFFFFFFFF
        b[1] = a[2]
        ta, tb = T(convert.desc_to_port(a)), T(convert.desc_to_port(b))
        np.testing.assert_array_equal(
            N(tham.hamming_matrix(ta, tb)),
            np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
        np.testing.assert_array_equal(
            N(tham.unpack_bits(ta)), np.asarray(jham.unpack_bits(jnp.asarray(a))))
        np.testing.assert_array_equal(
            N(tham.popcount(ta)), np.asarray(jham.popcount(jnp.asarray(a))))
        np.testing.assert_array_equal(
            N(tham.hamming_pairwise(ta, tb[:70])),
            np.asarray(jham.hamming_pairwise(jnp.asarray(a), jnp.asarray(b[:70]))))


def _stereo_inputs(jf_lr, orb):
    jl, jr = jf_lr
    return (jl.xy, jl.octave, jl.desc, jl.valid, jr.xy, jr.octave, jr.desc, jr.valid)


class TestStereo:
    def test_masked_median_matches_nanmedian(self):
        rng = np.random.default_rng(3)
        x = rng.uniform(0, 100, 41).astype(np.float32)
        for count in (1, 2, 7, 10, 41):
            mask = np.zeros(41, bool)
            mask[rng.choice(41, count, replace=False)] = True
            ref = float(jnp.nanmedian(jnp.where(jnp.asarray(mask), jnp.asarray(x), jnp.nan)))
            got = float(tstereo.masked_median(T(x), T(mask)))
            assert got == ref, count

    @pytest.mark.parametrize("parity", ["even", "odd"])
    def test_match_stereo_same_inputs(self, atlas_features, stereo_pair, cfgs,
                                      parity):
        """Both matchers on the same features and pyramids, with the left
        valid set cut so the number of matches entering the median SAD cut
        is even (the hazard: torch.nanmedian takes the lower middle) or
        odd.  Same matched set; u_right atol 1e-3 px; depth rtol 1e-4."""
        jc = cfgs[0]
        jf, _ = atlas_features
        l, r = stereo_pair
        jl = jpyr.build_pyramid(jnp.asarray(l), 1.2, 8)
        jr = jpyr.build_pyramid(jnp.asarray(r), 1.2, 8)
        sf = jnp.asarray(jc.orb.scale_factors, jnp.float32)
        args = _stereo_inputs(jf, jc.orb)
        kw = dict(bf=jc.camera.bf, max_disparity=jc.camera.fx, th_orb=75.0)
        ja_l, ja_r = jstereo.build_atlas(jl), jstereo.build_atlas(jr)
        ta_l = tstereo.build_atlas([T(np.asarray(x)) for x in jl])
        ta_r = tstereo.build_atlas([T(np.asarray(x)) for x in jr])

        def run_both(valid_l, median):
            a = list(args)
            a[3] = jnp.asarray(valid_l)
            ju, jd = jstereo.match_stereo(*a, ja_l, ja_r, sf, sad_median_filter=median, **kw)
            t = [T(np.asarray(x)) for x in a]
            t[2] = T(convert.desc_to_port(np.asarray(a[2])))
            t[6] = T(convert.desc_to_port(np.asarray(a[6])))
            tu, td = tstereo.match_stereo(*t, ta_l, ta_r, T(np.asarray(sf)),
                                          sad_median_filter=median, **kw)
            return np.asarray(ju), np.asarray(jd), N(tu), N(td)

        valid = np.asarray(args[3]).copy()
        ju, _, _, _ = run_both(valid, False)
        pre = np.nonzero(ju >= 0)[0]
        want_even = parity == "even"
        if (len(pre) % 2 == 0) != want_even:
            valid[pre[-1]] = False      # drop one pre-cut match
        ju0, _, _, _ = run_both(valid, False)
        assert ((ju0 >= 0).sum() % 2 == 0) == want_even
        ju, jd, tu, td = run_both(valid, True)
        m = ju >= 0
        assert m.sum() > 100
        np.testing.assert_array_equal(tu >= 0, m)
        np.testing.assert_allclose(tu[m], ju[m], atol=1e-3, rtol=0)
        np.testing.assert_allclose(td[m], jd[m], rtol=1e-4)

    def test_build_stereo_frame(self, frames):
        """The whole frame, each package end to end from the same images:
        same keypoints, same matched set, u_right atol 1e-3, depth rtol
        1e-4, descriptor bits >= 99.9% (see test_atlas_descriptors)."""
        jf, tf = frames
        ref = {k: np.asarray(v) for k, v in jf._asdict().items()}
        got = convert.frame_to_numpy(tf)
        for name in ("xy", "octave", "valid"):
            np.testing.assert_array_equal(got[name], ref[name], name)
        assert bit_agreement(ref["desc"], got["desc"]) >= 0.999
        np.testing.assert_array_equal(got["desc_bits"],
                                      np.asarray(jham.unpack_bits(jnp.asarray(got["desc"]))))
        m = ref["depth"] > 0
        assert m.sum() > 300
        np.testing.assert_array_equal(got["depth"] > 0, m)
        np.testing.assert_allclose(got["u_right"][m], ref["u_right"][m], atol=1e-3, rtol=0)
        np.testing.assert_allclose(got["depth"][m], ref["depth"][m], rtol=1e-4)

    def test_pack_and_unproject(self, frames, cfgs):
        _, tf = frames
        jc, tc = cfgs
        back = tframe.unpack_frame_np(N(tframe.pack_frame(tf)), tf.capacity)
        full = convert.frame_to_numpy(tf)
        for name, a in back.items():
            b = full[name]
            if name == "desc":
                a = convert.desc_from_port(a)
            np.testing.assert_array_equal(a, b, name)
        # the JAX package's packing of the port's frame is the same buffer
        jframe_of_port = jframe.StereoFrame(**{k: jnp.asarray(v) for k, v in full.items()})
        np.testing.assert_array_equal(N(tframe.pack_frame(tf)),
                                      np.asarray(jframe.pack_frame(jframe_of_port)))
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, 3] = [0.3, -0.1, 2.0]
        ref = np.asarray(jframe.unproject(jframe_of_port, jc, jnp.asarray(Twc)))
        got = N(tframe.unproject(tf, tc, T(Twc)))
        m = full["depth"] > 0
        np.testing.assert_allclose(got[m], ref[m], rtol=1e-5, atol=1e-4)


class TestGeometry:
    def test_se3_ops(self):
        rng = np.random.default_rng(8)
        xi = rng.normal(0, 0.4, (16, 6)).astype(np.float32)
        xi[0] = 0.0
        xi[1, :3] = 1e-6
        Tj = jse3.exp_se3(jnp.asarray(xi))
        Tt = tse3.exp_se3(T(xi))
        np.testing.assert_allclose(N(Tt), np.asarray(Tj), atol=1e-6)
        np.testing.assert_allclose(N(tse3.log_se3(Tt)), np.asarray(jse3.log_se3(Tj)),
                                   atol=1e-5)
        np.testing.assert_allclose(N(tse3.inverse(Tt)), np.asarray(jse3.inverse(Tj)),
                                   atol=1e-6)
        pts = rng.normal(0, 3, (16, 5, 3)).astype(np.float32)
        np.testing.assert_allclose(N(tse3.transform(Tt, T(pts))),
                                   np.asarray(jse3.transform(Tj, jnp.asarray(pts))),
                                   atol=1e-5)
        np.testing.assert_allclose(N(tse3.camera_center(Tt)),
                                   np.asarray(jse3.camera_center(Tj)), atol=1e-5)
        np.testing.assert_allclose(
            N(tse3.retract(Tt, T(xi[::-1].copy()))),
            np.asarray(jse3.retract(Tj, jnp.asarray(xi[::-1].copy()))), atol=1e-5)
        R = np.asarray(Tj)[:, :3, :3] + rng.normal(0, 1e-3, (16, 3, 3)).astype(np.float32)
        np.testing.assert_allclose(N(tse3.orthonormalize(T(R))),
                                   np.asarray(jse3.orthonormalize(jnp.asarray(R))),
                                   atol=1e-5)


class TestSynthetic:
    def test_renderer_matches(self):
        """The port's numpy renderer gives the JAX package's images."""
        tex_j = jsyn.make_texture(256, seed=4)
        tex_t = tsyn.make_texture(256, seed=4)
        np.testing.assert_array_equal(tex_t, tex_j)
        K = np.array([[60.0, 0, 40.0], [0, 60.0, 20.0], [0, 0, 1]])
        poses = jsyn.straight_trajectory(3, speed=0.8)
        np.testing.assert_array_equal(tsyn.straight_trajectory(3, speed=0.8), poses)
        for Twc in poses:
            a = jsyn.render_view(Twc, K, 80, 48, jsyn.corridor_scene(), tex_j)
            b = tsyn.render_view(Twc, K, 80, 48, tsyn.corridor_scene(), tex_t)
            np.testing.assert_array_equal(b, a)
