"""rvpt_tpu_torch.ops.film against rvpt_tpu.ops.film."""

import jax.numpy as jnp
import numpy as np
import torch

from rvpt_tpu.ops import film as jfilm
from rvpt_tpu_torch.ops import film as tfilm


def test_accumulate_with_dirty_reset_matches_jax():
    """Five EMA steps with a reset at step 3, within 1e-6."""
    r = np.random.default_rng(0)
    samples = r.uniform(0, 4, (5, 3, 6, 8)).astype(np.float32)
    dirty = [True, False, False, True, False]
    jf = jfilm.Film.create(6, 8)
    tf = tfilm.Film.create(6, 8)
    for s, dt in zip(samples, dirty):
        jf = jfilm.accumulate(jf, jnp.asarray(s), dt)
        tf = tfilm.accumulate(tf, torch.from_numpy(s), dt)
        assert tf.frame == int(jf.frame)
        np.testing.assert_allclose(tf.accum.numpy(), np.asarray(jf.accum),
                                   rtol=1e-6, atol=1e-6)
    assert tf.frame == 2


def test_to_srgb_u8_matches_jax_exactly():
    r = np.random.default_rng(1)
    img = r.uniform(-0.5, 1.5, (3, 16, 16)).astype(np.float32)
    # exact half steps exercise round-half-to-even
    img[0, 0, :4] = np.asarray([0.5, 1.5, 2.5, 127.5], np.float32) / 255.0
    want = np.asarray(jfilm.to_srgb_u8(jnp.asarray(img)))
    got = tfilm.to_srgb_u8(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_chw_hwc_roundtrip():
    x = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4)
    assert tfilm.chw_to_hwc(x).shape == (2, 4, 3)
    assert torch.equal(tfilm.hwc_to_chw(tfilm.chw_to_hwc(x)), x)
