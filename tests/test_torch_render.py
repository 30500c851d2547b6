"""The PyTorch port's device renderer (``io/render_torch.py``) against the
numpy ray-caster it ports and against the JAX package's renderer
(``io/render_jax.py``), on the CPU.

Gates against numpy are ``tests/test_render_jax.py``'s: pixel-exact
equality is not required (float32 against float64 ray math), the median
|difference| within the u8 step and under 2% of pixels off by more than
2.  The JAX package's renderer does the same float32 arithmetic, so the
port is held to it by the same gates.
"""

import numpy as np
import pytest
import torch

from pyorbslam_tpu.io.render_jax import JaxRenderer

from pyorbslam_tpu_torch.io import synthetic
from pyorbslam_tpu_torch.io.render_torch import TorchRenderer

# The whole test run has six workers on eight cores: with torch's default of
# one thread per core the workers contend, and the port's files run many
# times slower there than alone.
torch.set_num_threads(2)
W, H = 320, 96


def gates(got, want):
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return np.median(d), (d > 2).mean()


def test_render_torch_matches_numpy_and_jax_interior():
    tex = synthetic.make_texture(1024, seed=0)
    planes = synthetic.interior_loop_scene(30.0, tex_px_per_m=8.0, seed=0)
    K = np.array([[0.58 * W, 0, W / 2.0],
                  [0, 0.58 * W, H / 2.0 - 4.0],
                  [0, 0, 1.0]])
    poses = synthetic.loop_trajectory(40, radius=30.0, laps=1.0)
    r = TorchRenderer(planes, tex, "cpu")
    j = JaxRenderer(planes, tex)
    for i in (0, 13, 27):
        got = r.render(poses[i], K, W, H)
        ref = synthetic._to_u8(synthetic.render_view(poses[i], K, W, H, planes, tex))
        for want in (ref, j.render(poses[i], K, W, H)):
            med, frac = gates(got, want)
            assert med <= 1.0 and frac < 0.02, (i, med, frac)
        t = r.render_tensor(poses[i], K, W, H)
        assert t.device.type == "cpu" and t.dtype == torch.uint8


def test_stream_torch_backend(tmp_path):
    """``SyntheticStream(render_backend="torch")`` renders on the named
    device, caches under its own key, and meets the gates against the
    numpy backend's frames of the same world (one stream, its backend
    switched: the world's texture takes half a minute to make)."""
    stream = synthetic.SyntheticStream(
        n_frames=6, width=W, height=H, trajectory="straight", seed=11,
        render_backend="torch", render_device="cpu", cache_dir=str(tmp_path))
    frames = [stream.frame(i) for i in (0, 5)]
    stream.render_backend = "numpy"
    for i, pair in zip((0, 5), frames):
        for got, want in zip(pair, stream.frame(i)):
            med, frac = gates(got, want)
            assert med <= 1.0 and frac < 0.02, (i, med, frac)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == 4 and sum("_th_" in n for n in names) == 2, names
    stream.render_backend = "jax"
    with pytest.raises(ValueError, match="render backend"):
        stream.frame(1)
