"""Card-only checks (marker ``gpu``): skipped on any other platform.

Run on a machine with a GPU:
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_se_tpu.filters import particle_tiled as pft
from gpu_se_tpu.filters.resampling import (
    sorted_row_gather,
    systematic_resample_indices,
)
from resample_cases import REGIMES, regime_weights

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("kernel", pft.RESAMPLE_KERNELS)
def test_soa_resample_on_card_matches_reference(gpu_device, kernel, regime):
    """Compiled for the card (no interpreter): bitwise ancestors and rows
    against the plain reference run on the card."""
    n = 2**20 + 3
    rng = np.random.default_rng(0)
    x = jax.device_put(jnp.asarray(rng.standard_normal((5, n)), jnp.float32),
                       gpu_device)
    w = jax.device_put(jnp.asarray(regime_weights(regime, n)), gpu_device)
    r = jnp.float32(0.37)
    got, anc = jax.jit(lambda x, w: pft.resample(x, w, r, kernel=kernel))(x, w)
    idx = jax.jit(systematic_resample_indices)(w, r)
    np.testing.assert_array_equal(np.asarray(anc), np.asarray(idx))
    np.testing.assert_array_equal(
        np.asarray(got).T, np.asarray(jax.jit(sorted_row_gather)(x.T, idx)))
