"""Systematic-resampling property tests.

The reference validates its racy CUDA kernel only implicitly through a
parity test (SURVEY.md section 5 "race detection"); here the invariants are
checked directly: exact agreement with the sequential reference walk,
multiplicity counts, monotonicity.
"""
import jax
import jax.numpy as jnp
import numpy as np

import pytest

from gpu_se_tpu.filters.resampling import (
    ends_from_weights,
    systematic_resample,
    systematic_resample_indices,
)
from resample_cases import NS, REGIMES, regime_weights


def reference_walk(weights, r):
    """The reference CPU algorithm, verbatim semantics
    (/root/reference/filter/particle.py:89-100)."""
    cumsum = np.cumsum(weights)
    cumsum = cumsum / cumsum[-1]
    n = len(weights)
    out = np.zeros(n, dtype=np.int64)
    k = 0
    for i in range(n):
        u = (i + r) / n
        while cumsum[k] < u:
            k += 1
        out[i] = k
    return out


def test_matches_reference_walk():
    rng = np.random.default_rng(0)
    for n in (1, 5, 32, 1000):
        w = rng.uniform(0.0, 1.0, n).astype(np.float32) + 1e-6
        for r in (0.0, 0.123, 0.5, 0.999):
            got = np.asarray(
                systematic_resample_indices(jnp.asarray(w), jnp.float32(r))
            )
            want = reference_walk(w.astype(np.float64), r)
            np.testing.assert_array_equal(got, want)


def test_indices_monotone_and_multiplicity():
    rng = np.random.default_rng(1)
    n = 4096
    w = rng.exponential(size=n).astype(np.float32)
    idx = np.asarray(systematic_resample_indices(jnp.asarray(w), jnp.float32(0.37)))
    # systematic resampling yields sorted ancestor indices
    assert np.all(np.diff(idx) >= 0)
    # multiplicity of index k is floor(N*W_k - r) - floor(N*W_{k-1} - r) in {floor,ceil}(N w_k)
    counts = np.bincount(idx, minlength=n)
    expected = n * (w / w.sum())
    assert np.all(np.abs(counts - expected) <= 1.0 + 1e-5)


def test_degenerate_single_heavy_weight():
    n = 128
    w = np.full(n, 1e-12, dtype=np.float32)
    w[17] = 1.0
    idx = np.asarray(systematic_resample_indices(jnp.asarray(w), jnp.float32(0.5)))
    assert np.all(idx == 17)


def test_uniform_weights_identity():
    n = 256
    w = np.full(n, 1.0 / n, dtype=np.float32)
    idx = np.asarray(systematic_resample_indices(jnp.asarray(w), jnp.float32(0.5)))
    np.testing.assert_array_equal(idx, np.arange(n))


def test_resample_pytree_gather():
    key = jax.random.PRNGKey(0)
    n = 64
    parts = jnp.arange(n * 3, dtype=jnp.float32).reshape(n, 3)
    covs = jnp.tile(jnp.eye(2)[None], (n, 1, 1)) * jnp.arange(n)[:, None, None]
    w = jnp.ones(n).at[5].set(1000.0)
    (p2, c2), w2 = systematic_resample((parts, covs), w, key)
    assert p2.shape == parts.shape and c2.shape == covs.shape
    np.testing.assert_allclose(np.asarray(w2), 1.0 / n)
    # heavy particle dominates the output
    frac5 = np.mean(np.asarray(p2[:, 0]) == float(parts[5, 0]))
    assert frac5 > 0.9


def test_resample_under_jit():
    f = jax.jit(systematic_resample_indices)
    w = jnp.asarray(np.random.default_rng(2).uniform(size=512).astype(np.float32))
    a = np.asarray(f(w, jnp.float32(0.25)))
    b = np.asarray(systematic_resample_indices(w, jnp.float32(0.25)))
    np.testing.assert_array_equal(a, b)


def test_mixed_dtype_routing_stays_exact():
    """Every leaf keeps its dtype through the resample: int32 values
    beyond f32's 24-bit mantissa survive exactly."""
    n = 2 ** 13
    means = jnp.zeros((n, 5), jnp.float32)
    w = jnp.exp(jnp.linspace(-3.0, 2.0, n, dtype=jnp.float32))
    key = jax.random.PRNGKey(7)
    vals = (jnp.arange(n, dtype=jnp.int32) + 2 ** 24 + 1)[:, None]
    (out_m, out_v), _ = systematic_resample((means, vals), w, key)
    assert out_v.dtype == jnp.int32 and out_m.dtype == jnp.float32
    idx = systematic_resample_indices(w, jax.random.uniform(key, ()))
    np.testing.assert_array_equal(
        np.asarray(out_v[:, 0]), np.asarray(vals[np.asarray(idx), 0])
    )


@pytest.mark.parametrize("r", (0.0, 0.37, 0.999))
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("n", NS)
def test_systematic_invariants(n, regime, r):
    """Counts, monotone ancestors, and the ancestors as a binary search of
    the integer segment ends, for every weight regime."""
    w = regime_weights(regime, n, seed=n)
    r32 = jnp.float32(r)
    ends = np.asarray(ends_from_weights(jnp.asarray(w), r32))
    idx = np.asarray(systematic_resample_indices(jnp.asarray(w), r32))
    assert idx.dtype == np.int32 and idx.shape == (n,)
    assert np.all(np.diff(idx) >= 0) and 0 <= idx[0] and idx[-1] < n
    assert np.all(np.diff(ends) >= 0) and ends[-1] == n - 1
    np.testing.assert_array_equal(
        idx, np.searchsorted(ends, np.arange(n), side="left"))
    # particle k is drawn floor or ceil of n * (its normalized weight)
    # times, up to the float32 rounding of the cumsum (a few ulps of 1,
    # i.e. a few times n * 2^-24 slots)
    counts = np.bincount(idx, minlength=n)
    expected = n * (w.astype(np.float64) / w.astype(np.float64).sum())
    assert np.all(np.abs(counts - expected) <= 1.0 + n * 2.0 ** -20)
    assert counts.sum() == n
