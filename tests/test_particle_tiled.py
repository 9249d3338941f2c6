"""Structure-of-arrays PF step tests.

Pins the step of filters/particle_tiled.py bitwise against a flat
``(N, nx)`` comparator built from the plain reference
(``systematic_resample_indices`` + ``sorted_row_gather``) — across
particle counts (including one that is no power of two), state
dimensions and weight regimes — so any divergence is a bug in the SoA
plumbing, not a stream/association artifact. Also: chained steps, the
point estimate, and statistical agreement with ``particle.step``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_se_tpu.distributions import GaussianSum
from gpu_se_tpu.filters import particle as pf_core
from gpu_se_tpu.filters import particle_tiled as pft
from gpu_se_tpu.filters.resampling import (
    sorted_row_gather,
    systematic_resample_indices,
)
from gpu_se_tpu.models import bioreactor as bio
from gpu_se_tpu.sim import filter_rig
from resample_cases import NS, NXS, REGIMES, regime_weights

F_BIO = functools.partial(bio.homeostatic_des, xp=jnp)
G_BIO = functools.partial(bio.static_outputs, xp=jnp)
DT = jnp.float32(0.1)


def _toy_model(nx: int):
    """A stable linear toy model on ``nx`` states, two measured; written
    for the ``(nx, N)`` row layout like the bioreactor functions."""
    decay = jnp.linspace(0.05, 0.3, nx, dtype=jnp.float32)[:, None]

    def f(x, u, dt):
        return -decay * x * dt + u[0] * dt

    def g(x, u):
        return x[:2]

    state_pdf = GaussianSum.create(
        np.zeros((2, nx)),
        np.stack([np.eye(nx) * 1e-3, np.eye(nx) * 1e-2]),
        np.array([0.75, 0.25]),
    )
    meas_pdf = GaussianSum.create(
        np.zeros((2, 2)),
        np.stack([np.eye(2) * 0.05, np.eye(2) * 5.0]),
        np.array([0.85, 0.15]),
    )
    x0 = GaussianSum.create(np.ones((1, nx)), np.eye(nx)[None] * 0.1, [1.0])
    return f, g, state_pdf, meas_pdf, x0


def _flat_comparator_step(particles, key, u, z, f, g, state_pdf, meas_pdf):
    """The same semantics on the flat (N, nx) layout with the plain
    resample: bitwise-identical values by construction (elementwise ops
    and an exact gather on another shape)."""
    n = particles.shape[0]
    key, kn, kr = jax.random.split(key, 3)
    x = particles.T
    xn = x + f(x, u, DT) + state_pdf.draw_t(kn, n)
    w = meas_pdf.pdf_t(z.reshape(-1, 1) - g(xn, u))
    r = jax.random.uniform(kr, (), dtype=jnp.float32)
    idx = systematic_resample_indices(w, r)
    return sorted_row_gather(xn.T, idx), idx, key


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("nx", NXS)
@pytest.mark.parametrize("n", NS)
def test_resample_matches_flat_comparator(n, nx, regime):
    rng = np.random.default_rng(n + nx)
    x = jnp.asarray(rng.standard_normal((nx, n)), jnp.float32)
    w = jnp.asarray(regime_weights(regime, n))
    r = jnp.float32(0.37)
    got, anc = jax.jit(pft.resample)(x, w, r)
    idx = systematic_resample_indices(w, r)
    np.testing.assert_array_equal(np.asarray(anc), np.asarray(idx))
    np.testing.assert_array_equal(
        np.asarray(got).T, np.asarray(sorted_row_gather(x.T, idx)))


@pytest.mark.parametrize("nx", NXS)
@pytest.mark.parametrize("n", NS)
def test_step_bitwise_vs_flat_comparator(n, nx):
    f, g, state_pdf, meas_pdf, x0 = _toy_model(nx)
    u = jnp.array([0.5], jnp.float32)
    z = jnp.array([1.2, 0.8], jnp.float32)
    key = jax.random.PRNGKey(n + nx)
    parts = x0.draw(jax.random.PRNGKey(3), (n,))
    # both sides op by op: a fused jit may contract the arithmetic
    # differently and move the floats by an ulp
    out = pft.step(pft.SoAPFState(x=parts.T, key=key), u, z, DT, f, g,
                   state_pdf, meas_pdf)
    want, _, _ = _flat_comparator_step(
        parts, key, u, z, f, g, state_pdf, meas_pdf)
    np.testing.assert_array_equal(np.asarray(out.x).T, np.asarray(want))


def test_step_bitwise_degenerate_weights():
    """Hyper-degenerate bench-rig weights: still bitwise-equal to the
    plain route."""
    x0, state_pdf, meas_pdf, u, z = filter_rig()
    # an offset measurement concentrates the weights hard (few distinct
    # ancestors) while keeping them nonzero
    z = z + jnp.asarray([0.3, 0.3], jnp.float32)
    n = 8192
    key = jax.random.PRNGKey(21)
    parts = x0.draw(jax.random.PRNGKey(5), (n,))
    out = pft.step(pft.SoAPFState(x=parts.T, key=key), u, z, DT, F_BIO,
                   G_BIO, state_pdf, meas_pdf)
    want, idx, _ = _flat_comparator_step(
        parts, key, u, z, F_BIO, G_BIO, state_pdf, meas_pdf)
    assert len(np.unique(np.asarray(idx))) < n // 8
    np.testing.assert_array_equal(np.asarray(out.x).T, np.asarray(want))


def test_chained_steps_bitwise():
    """Three chained SoA steps == three chained flat-comparator steps."""
    x0, state_pdf, meas_pdf, u, z = filter_rig()
    n = 8192
    key = jax.random.PRNGKey(11)
    parts = x0.draw(jax.random.PRNGKey(4), (n,))
    st = pft.SoAPFState(x=parts.T, key=key)
    flat, fkey = parts, key
    for _ in range(3):
        st = pft.step(st, u, z, DT, F_BIO, G_BIO, state_pdf, meas_pdf)
        flat, _, fkey = _flat_comparator_step(
            flat, fkey, u, z, F_BIO, G_BIO, state_pdf, meas_pdf)
    np.testing.assert_array_equal(np.asarray(st.x).T, np.asarray(flat))


def test_init_uses_draw_t_stream():
    x0, *_ = filter_rig()
    key = jax.random.PRNGKey(2)
    st = pft.init(key, 4096, x0)
    _, sub = jax.random.split(key)
    np.testing.assert_array_equal(np.asarray(st.x),
                                  np.asarray(x0.draw_t(sub, 4096)))
    assert st.n_particles == 4096


def test_unknown_kernel_rejected():
    x = jnp.zeros((2, 16), jnp.float32)
    with pytest.raises(ValueError, match="kernel"):
        pft.resample(x, jnp.ones(16), jnp.float32(0.5), kernel="v4")


def test_point_estimate_matches_untiled_mean():
    rng = np.random.default_rng(2)
    parts = rng.standard_normal((8192, 5)).astype(np.float32)
    st = pft.SoAPFState(x=jnp.asarray(parts.T), key=jax.random.PRNGKey(0))
    got = np.asarray(pft.point_estimate(st))
    np.testing.assert_allclose(got, parts.mean(axis=0), rtol=2e-5, atol=2e-6)


def test_statistical_agreement_with_untiled_step():
    """Different noise stream/association than particle.step, same
    distribution: after one step from the same start, the particle
    means must agree to sampling error."""
    x0, state_pdf, meas_pdf, u, z = filter_rig()
    n = 8192
    parts = x0.draw(jax.random.PRNGKey(9), (n,))
    st = pft.step(pft.SoAPFState(x=parts.T, key=jax.random.PRNGKey(100)),
                  u, z, DT, F_BIO, G_BIO, state_pdf, meas_pdf)
    soa_mean = np.asarray(pft.point_estimate(st))

    ref_state = pf_core.PFState(
        particles=parts,
        weights=jnp.full((n,), 1.0 / n, jnp.float32),
        key=jax.random.PRNGKey(200),
    )
    ref_state = pf_core.step(
        ref_state, u, z, DT,
        bio.Bioreactor.homeostatic_DEs, bio.Bioreactor.static_outputs,
        state_pdf, meas_pdf)
    ref_mean = np.asarray(pf_core.point_estimate(ref_state))
    scale = np.maximum(np.abs(ref_mean), 0.05)
    assert np.all(np.abs(soa_mean - ref_mean) / scale < 0.2)


def test_pdf_t_matches_pdf():
    _, _, meas_pdf, _, _ = filter_rig()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 257)).astype(np.float32)
    got = np.asarray(meas_pdf.pdf_t(jnp.asarray(x)))
    want = np.asarray(meas_pdf.pdf(jnp.asarray(x.T)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)
