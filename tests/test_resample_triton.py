"""The fused search + gather resample kernel (ops/resample_triton.py) in
the Pallas interpreter, against the plain reference: bitwise ancestors
and rows for every weight regime, particle counts that are and are not
multiples of the block, and the wrapper's routing through
``particle_tiled.resample``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_se_tpu.filters import particle_tiled as pft
from gpu_se_tpu.filters.resampling import ends_from_weights, indices_from_ends
from gpu_se_tpu.ops.resample_triton import resample_gather
from resample_cases import NS, REGIMES, regime_weights


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("n", NS)
def test_kernel_matches_reference(n, regime):
    rng = np.random.default_rng(n)
    x = jnp.asarray(rng.standard_normal((5, n)), jnp.float32)
    ends = ends_from_weights(jnp.asarray(regime_weights(regime, n)),
                             jnp.float32(0.61))
    out, anc = resample_gather(x, ends, interpret=True)
    idx = indices_from_ends(ends)
    np.testing.assert_array_equal(np.asarray(anc), np.asarray(idx))
    np.testing.assert_array_equal(np.asarray(out),
                                  np.asarray(x)[:, np.asarray(idx)])


@pytest.mark.parametrize("block", (128, 256, 2048))
@pytest.mark.parametrize("n", (1, 7, 1000, 4097))
def test_kernel_pads_partial_blocks(n, block):
    """Counts below, at and past one block: the padded tail slots are
    clamped in bounds and sliced off."""
    rng = np.random.default_rng(n + block)
    x = jnp.asarray(rng.standard_normal((3, n)), jnp.float32)
    ends = ends_from_weights(
        jnp.asarray(rng.exponential(size=n).astype(np.float32)),
        jnp.float32(0.2))
    out, anc = resample_gather(x, ends, block=block, interpret=True)
    assert out.shape == (3, n) and anc.shape == (n,)
    idx = np.asarray(indices_from_ends(ends))
    np.testing.assert_array_equal(np.asarray(anc), idx)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x)[:, idx])


def test_wrapper_routes_to_kernel():
    n = 5000
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((7, n)), jnp.float32)
    w = jnp.asarray(regime_weights("heavy_tailed", n))
    r = jnp.float32(0.25)
    got, anc = pft.resample(x, w, r, kernel="triton", interpret=True)
    want, anc_xla = jax.jit(pft.resample)(x, w, r)
    np.testing.assert_array_equal(np.asarray(anc), np.asarray(anc_xla))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
