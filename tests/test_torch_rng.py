"""rvpt_tpu_torch.core.rng is bit-exact with rvpt_tpu.core.rng."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvpt_tpu.core import rng as jrng
from rvpt_tpu_torch.core import rng as trng

N = 10_000


def _u32_inputs(k, seed=0):
    r = np.random.default_rng(seed)
    v = r.integers(0, 2**32, size=(k, N), dtype=np.uint64).astype(np.uint32)
    v[:, :4] = [0, 1, 2**31, 2**32 - 1]  # edges, incl. >= 2^31
    assert (v >= 2**31).any()
    return v


def _both(v):
    return ([jnp.asarray(x) for x in v],
            [torch.from_numpy(x.astype(np.int64)) for x in v])


@pytest.mark.parametrize("fn", ["pcg3d", "pcg4d"])
def test_hash_bit_exact(fn):
    v = _u32_inputs(3 if fn == "pcg3d" else 4)
    jv, tv = _both(v)
    want = getattr(jrng, fn)(*jv)
    got = getattr(trng, fn)(*tv)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64), g.numpy())


@pytest.mark.parametrize("fn", ["uniform1", "uniform2", "uniform3", "uniform4"])
def test_uniforms_bit_exact(fn):
    v = _u32_inputs(4 if fn == "uniform4" else 3, seed=1)
    jv, tv = _both(v)
    want = getattr(jrng, fn)(*jv)
    got = getattr(trng, fn)(*tv)
    if fn == "uniform1":
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_scalar_counters_broadcast():
    """Python-int frame/salt (the render path's form) give the same
    streams as u32 arrays."""
    pix = np.arange(1000, dtype=np.uint32) * 2654435761
    want = jrng.uniform3(jnp.asarray(pix), jnp.uint32(7), jnp.uint32(4096 + 16))
    got = trng.uniform3(torch.from_numpy(pix.astype(np.int64)), 7, 4096 + 16)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
