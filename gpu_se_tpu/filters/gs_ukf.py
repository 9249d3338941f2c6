"""Gaussian-sum unscented Kalman filter (bank of UKFs + importance weights).

Functional core over :class:`GSUKFState` replaces the reference CPU/GPU
pair (/root/reference/filter/gs_ukf.py:9-183, :186-449). All per-Gaussian
work (sigma points, unscented transform, Kalman gain) is batched over the
bank axis as elementwise array math instead of Python double loops or
guvectorized CUDA kernels. Cholesky failure handling is branchless
(jitter-on-NaN) rather than exception retry, since exceptions cannot
cross ``jit`` (cf. the try/except at /root/reference/filter/gs_ukf.py:72-75).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from gpu_se_tpu import pytree

from gpu_se_tpu.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu.filters.resampling import systematic_resample
from gpu_se_tpu.ops.smallmat import (
    cholesky_small,
    cholesky_small_lanes,
    inv_small_jittered_lanes,
)


@pytree.dataclass
class GSUKFState:
    """means (N, Nx), covariances (N, Nx, Nx), weights (N,), PRNG key."""

    means: jax.Array
    covariances: jax.Array
    weights: jax.Array
    key: jax.Array

    @property
    def n_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def n_dim(self) -> int:
        return self.means.shape[1]


def sigma_weights(nx: int, dtype=jnp.float32) -> jax.Array:
    """Custom sigma weights: w_mu + 2*nx*w_sigma = 1 and
    w_mu / w_sigma ~ N(0)/N(sigma) (cf. /root/reference/filter/gs_ukf.py:63-67)."""
    n_sigmas = 2 * nx + 1
    w = jnp.full((n_sigmas,), 1.0 / (2 * nx + 8.0 / 5.0), dtype=dtype)
    return w.at[0].set(1.0 / (1.0 + 5.0 / 4.0 * nx))


def _batched_cholesky_jittered(covs: jax.Array, jitter: float = 1e-10) -> jax.Array:
    """Batched Cholesky with branchless jitter fallback on failure.

    jnp.linalg.cholesky yields NaNs (not exceptions) for non-PD inputs;
    where that happens, redo with ``jitter * I`` added — the jit-safe
    version of the retry at /root/reference/filter/gs_ukf.py:72-75.
    """
    nx = covs.shape[-1]
    eye = jnp.eye(nx, dtype=covs.dtype)
    l0 = cholesky_small(covs)
    bad = jnp.isnan(l0).any(axis=(-2, -1), keepdims=True)
    l1 = cholesky_small(covs + jitter * eye)
    return jnp.where(bad, l1, l0)


def get_sigma_points(state: GSUKFState) -> jax.Array:
    """(N, 2*Nx+1, Nx) sigma points: mean, mean + rows(L^T), mean - rows(L^T)
    (cf. /root/reference/filter/gs_ukf.py:69-80)."""
    stds = _batched_cholesky_jittered(state.covariances)
    stds_t = jnp.swapaxes(stds, -1, -2)  # rows are scaled directions
    mean = state.means[:, None, :]
    return jnp.concatenate([mean, mean + stds_t, mean - stds_t], axis=1)


# ----------------------------------------------------------------------
def init(
    key: jax.Array,
    n_gaussians: int,
    x0: GaussianSum,
    state_pdf: GaussianSum,
    dtype=jnp.float32,
) -> GSUKFState:
    """Initial bank: means drawn from x0, covariances = first state-noise
    component repeated (cf. /root/reference/filter/gs_ukf.py:50-54)."""
    key, sub = jax.random.split(key)
    means = x0.draw(sub, (n_gaussians,)).astype(dtype)
    covs = jnp.broadcast_to(
        state_pdf.covariances[0][None], (n_gaussians,) + state_pdf.covariances[0].shape
    ).astype(dtype)
    weights = jnp.full((n_gaussians,), 1.0 / n_gaussians, dtype=dtype)
    return GSUKFState(means=means, covariances=covs, weights=weights, key=key)


def _sigma_points_lanes(means_t, covs_t):
    """Sigma points in lanes-last layout: ``means_t (nx, N)``,
    ``covs_t (nx, nx, N)`` -> ``(2*nx+1, nx, N)``.

    Same construction as :func:`get_sigma_points` (mean, mean ± columns
    of the jittered Cholesky factor), identical op order — only the
    layout differs: the big bank axis N stays minor (see
    ops/smallmat's lanes-last section).
    """
    nx = means_t.shape[0]
    l0 = cholesky_small_lanes(covs_t)
    bad = jnp.isnan(l0).any(axis=(0, 1), keepdims=True)
    eye = jnp.eye(nx, dtype=covs_t.dtype).reshape(
        (nx, nx) + (1,) * (covs_t.ndim - 2))
    l1 = cholesky_small_lanes(covs_t + 1e-10 * eye)
    l_t = jnp.where(bad, l1, l0)
    return jnp.stack(
        [means_t]
        + [means_t + l_t[:, i] for i in range(nx)]
        + [means_t - l_t[:, i] for i in range(nx)]
    )


def _vmap_lanes2(fn):
    """vmap a per-vector fn over (s, nx, N): axis 0 (sigma) and the
    trailing lane axis. Works for ANY user f/g written for (nx,)
    vectors; array layouts stay lanes-last throughout."""
    inner = jax.vmap(fn, in_axes=(1, None, None), out_axes=1)
    return jax.vmap(inner, in_axes=(0, None, None), out_axes=0)


def predict_core(means, covariances, u, dt, noise, f: Callable,
                 noise_is_lanes: bool = False):
    """Deterministic unscented prediction given pre-drawn sigma-point noise
    ``noise (N, 2*Nx+1, Nx)``. Shared by the single-device step and the
    explicit shard_map path (noise drawn outside with partitionable keys).
    Noise is added to the sigma points before recombination (deliberate
    covariance inflation, cf. /root/reference/filter/gs_ukf.py:82-103).

    Internally computed in lanes-last layout (bank axis N minor); the
    (N, ...) API is unchanged.
    """
    nx = means.shape[1]
    w_sigma = sigma_weights(nx, means.dtype)  # (2nx+1,)
    means_t = means.T                                   # (nx, N)
    covs_t = jnp.transpose(covariances, (1, 2, 0))      # (nx, nx, N)
    sig = _sigma_points_lanes(means_t, covs_t)          # (s, nx, N)

    def f_vec(x, uu, ddt):
        return f(x, uu, ddt)

    deltas = _vmap_lanes2(f_vec)(sig, u, dt)
    # noise arrives (N, s, nx) from the shared API or already lanes-last
    # (s, nx, N) from the single-device draw_t fast path
    noise_t = noise if noise_is_lanes else jnp.transpose(noise, (1, 2, 0))
    sig = sig + deltas + noise_t
    ws = w_sigma.reshape(-1, 1, 1)
    new_means_t = jnp.sum(ws * sig, axis=0)             # (nx, N)
    cent = sig - new_means_t[None]                      # (s, nx, N)
    # accumulate the weighted outer products per sigma point instead of
    # materializing the rank-4 (s, nx, nx, N) product (less padded
    # intermediate traffic; identical summation order over s)
    covs_new_t = None
    for si in range(cent.shape[0]):
        term = w_sigma[si] * (cent[si][:, None, :] * cent[si][None, :, :])
        covs_new_t = term if covs_new_t is None else covs_new_t + term
    return new_means_t.T, jnp.transpose(covs_new_t, (2, 0, 1))


def predict(
    state: GSUKFState, u: jax.Array, dt, f: Callable, state_pdf: GaussianSum
) -> GSUKFState:
    """Unscented prediction (cf. /root/reference/filter/gs_ukf.py:82-103)."""
    n, nx = state.means.shape
    key, sub = jax.random.split(state.key)
    # lanes-last draw (the bank axis stays minor end to end)
    s_sig = 2 * nx + 1
    noise_t = state_pdf.draw_t(sub, n * s_sig).reshape(nx, s_sig, n)
    noise_t = jnp.transpose(noise_t, (1, 0, 2))         # (s, nx, N)
    means, covs = predict_core(
        state.means, state.covariances, u, dt, noise_t, f,
        noise_is_lanes=True)
    return GSUKFState(means=means, covariances=covs, weights=state.weights, key=key)


def update_core(means, covariances, weights, u, z, g: Callable,
                measurement_pdf: GaussianSum, return_eta: bool = False):
    """Per-Gaussian local UKF measurement update + global weight update
    (cf. /root/reference/filter/gs_ukf.py:105-149). Pure over arrays so
    the shard_map path can reuse it shard-locally.

    Lanes-last internally (see :func:`predict_core`): the bank axis N
    stays minor through every intermediate.
    """
    nx = means.shape[1]
    w_sigma = sigma_weights(nx, means.dtype)
    means_t = means.T                                   # (nx, N)
    covs_t = jnp.transpose(covariances, (1, 2, 0))      # (nx, nx, N)
    # jittered Cholesky factor; centered sigma points are EXACTLY its
    # columns (0, +l_i, -l_i), so the (s, nx, N) sigma stack never needs
    # to exist here
    l0 = cholesky_small_lanes(covs_t)
    bad = jnp.isnan(l0).any(axis=(0, 1), keepdims=True)
    eye = jnp.eye(nx, dtype=covs_t.dtype).reshape(nx, nx, 1)
    l_t = jnp.where(bad, cholesky_small_lanes(covs_t + 1e-10 * eye), l0)

    inner_g = jax.vmap(g, in_axes=(1, None), out_axes=1)

    def sigma_i(si):
        if si == 0:
            return means_t
        if si <= nx:
            return means_t + l_t[:, si - 1]
        return means_t - l_t[:, si - 1 - nx]

    etas = [inner_g(sigma_i(si), u) for si in range(2 * nx + 1)]
    eta_means_t = None                                  # (ny, N)
    for si, e in enumerate(etas):
        t = w_sigma[si] * e
        eta_means_t = t if eta_means_t is None else eta_means_t + t

    p_xy_t = None                                        # (nx, ny, N)
    p_yy_t = None                                        # (ny, ny, N)
    for si, e in enumerate(etas):
        eta_c = e - eta_means_t                          # (ny, N)
        w_eta = w_sigma[si] * eta_c
        tyy = eta_c[:, None, :] * w_eta[None, :, :]
        p_yy_t = tyy if p_yy_t is None else p_yy_t + tyy
        if si == 0:
            continue                                     # centered sigma = 0
        sc = l_t[:, si - 1] if si <= nx else -l_t[:, si - 1 - nx]
        txy = sc[:, None, :] * w_eta[None, :, :]
        p_xy_t = txy if p_xy_t is None else p_xy_t + txy
    # degenerate-P_yy safe gain solve (reference CPU uses pinv,
    # /root/reference/filter/gs_ukf.py:134)
    inv_t = inv_small_jittered_lanes(p_yy_t)            # (ny, ny, N)
    gains_t = jnp.sum(
        p_xy_t[:, :, None, :] * inv_t[None, :, :, :], axis=1
    )                                                    # (nx, ny, N)

    es_t = z[:, None] - eta_means_t                     # (ny, N)
    new_means_t = means_t + jnp.sum(gains_t * es_t[None], axis=1)
    # "Dimensions from paper do not work, use corrected version"
    # (/root/reference/filter/gs_ukf.py:139)
    kp_t = jnp.sum(
        gains_t[:, :, None, :] * p_yy_t[None, :, :, :], axis=1
    )                                                    # (nx, ny, N)
    kpk_t = jnp.sum(
        kp_t[:, None, :, :] * gains_t[None, :, :, :], axis=2
    )                                                    # (nx, nx, N)
    # K P K' is symmetric in exact arithmetic but its f32 accumulation
    # is not (kpk[i,j] and kpk[j,i] group the same terms differently);
    # symmetrize so the bank covariances stay EXACTLY symmetric
    kpk_t = 0.5 * (kpk_t + jnp.swapaxes(kpk_t, 0, 1))
    covs_new_t = covs_t - kpk_t

    y_means_t = jax.vmap(g, in_axes=(1, None), out_axes=1)(new_means_t, u)
    eta = (z[:, None] - y_means_t).T                     # (N, ny)
    if return_eta:
        # caller does its own weight update (e.g. log-space in
        # update_stabilized) — skip the linear pdf multiply entirely
        return new_means_t.T, jnp.transpose(covs_new_t, (2, 0, 1)), eta
    new_weights = weights * measurement_pdf.pdf(eta)
    return (
        new_means_t.T,
        jnp.transpose(covs_new_t, (2, 0, 1)),
        new_weights,
    )


def update(
    state: GSUKFState,
    u: jax.Array,
    z: jax.Array,
    g: Callable,
    measurement_pdf: GaussianSum,
) -> GSUKFState:
    """Per-Gaussian local UKF measurement update + global weight update
    (cf. /root/reference/filter/gs_ukf.py:105-149)."""
    means, covs, weights = update_core(
        state.means, state.covariances, state.weights, u, z, g, measurement_pdf
    )
    return GSUKFState(means=means, covariances=covs, weights=weights, key=state.key)


def update_stabilized(
    state: GSUKFState, u: jax.Array, z: jax.Array, g: Callable,
    measurement_pdf: GaussianSum,
) -> GSUKFState:
    """Local UKF update + log-space global weight update (the stable form
    of the reference's ad-hoc /=1e3 rescale, SURVEY.md Appendix A)."""
    means, covs, eta = update_core(
        state.means, state.covariances, state.weights, u, z, g,
        measurement_pdf, return_eta=True,
    )
    logw = jnp.log(jnp.maximum(state.weights, 1e-38)) + measurement_pdf.logpdf(eta)
    logw = logw - jnp.max(logw)
    w = jnp.exp(logw)
    return GSUKFState(
        means=means, covariances=covs, weights=w / jnp.sum(w), key=state.key
    )


def resample(state: GSUKFState) -> GSUKFState:
    """Systematic resample of (means, covariances)
    (cf. /root/reference/filter/gs_ukf.py:151-170)."""
    key, sub = jax.random.split(state.key)
    (means, covs), weights = systematic_resample(
        (state.means, state.covariances), state.weights, sub
    )
    return GSUKFState(means=means, covariances=covs, weights=weights, key=key)


def step(state, u, z, dt, f, g, state_pdf, measurement_pdf) -> GSUKFState:
    """Fused predict + update + resample."""
    state = predict(state, u, dt, f, state_pdf)
    state = update(state, u, z, g, measurement_pdf)
    return resample(state)


def point_estimate(state: GSUKFState) -> jax.Array:
    """Weighted mean of the bank (blocked reduction — a naive f32 sum
    ulp-starves at large N; see ops/reduce.py)."""
    from gpu_se_tpu.ops.reduce import weighted_mean

    return weighted_mean(state.weights, state.means)


def point_covariance(state: GSUKFState) -> jax.Array:
    """Max singular value of total covariance: E[cov] + Var[means]
    (cf. /root/reference/filter/gs_ukf.py:176-183)."""
    from gpu_se_tpu.ops.reduce import blocked_outer_sum, blocked_sum, weighted_mean

    w = state.weights / blocked_sum(state.weights)
    cov_cov = blocked_sum(w[:, None, None] * state.covariances)
    mean = weighted_mean(state.weights, state.means)
    dist = state.means - mean
    cov_mean = blocked_outer_sum(dist, dist * w[:, None])
    s = jnp.linalg.svd(cov_cov + cov_mean, compute_uv=False)
    return s[0]


# ----------------------------------------------------------------------
class GaussianSumUnscentedKalmanFilter:
    """Stateful shell with the reference six-method API."""

    def __init__(
        self,
        f,
        g,
        N_particles,
        x0,
        state_pdf,
        measurement_pdf,
        seed: int = 0,
        device=None,
        stabilized: bool = False,
    ):
        from gpu_se_tpu.filters.particle import _as_dist

        self.f, self.g = f, g
        self.N_particles = int(N_particles)
        self.state_pdf = _as_dist(state_pdf)
        self.measurement_pdf = _as_dist(measurement_pdf)
        self._stabilized = stabilized
        x0 = _as_dist(x0)

        key = jax.random.PRNGKey(seed)
        self.state = init(key, self.N_particles, x0, self.state_pdf)
        if device is not None:
            self.state = jax.device_put(self.state, device)

        upd = update_stabilized if stabilized else update
        self._predict = jax.jit(partial(predict, f=self.f))
        self._update = jax.jit(partial(upd, g=self.g))
        self._resample = jax.jit(resample)

        def _full_step(state, u, z, dt, state_pdf, measurement_pdf):
            state = predict(state, u, dt, self.f, state_pdf)
            state = upd(state, u, z, self.g, measurement_pdf)
            return resample(state)

        self._step = jax.jit(_full_step)
        self._point_estimate = jax.jit(point_estimate)
        self._point_covariance = jax.jit(point_covariance)
        self._moments = jax.jit(
            lambda s: (point_estimate(s), point_covariance(s))
        )
        self._moments_cache = None

    def _set_state(self, state):
        self.state = state
        self._moments_cache = None

    def predict(self, u, dt):
        self._set_state(self._predict(
            self.state, jnp.asarray(u), jnp.asarray(dt, jnp.float32),
            state_pdf=self.state_pdf,
        ))

    def update(self, u, z):
        self._set_state(self._update(
            self.state, jnp.asarray(u), jnp.asarray(z),
            measurement_pdf=self.measurement_pdf,
        ))

    def resample(self):
        self._set_state(self._resample(self.state))

    def step(self, u, z, dt):
        self._set_state(self._step(
            self.state, jnp.asarray(u), jnp.asarray(z), jnp.asarray(dt, jnp.float32),
            state_pdf=self.state_pdf, measurement_pdf=self.measurement_pdf,
        ))

    def point_estimate(self):
        return self._point_estimate(self.state)

    def point_covariance(self):
        return self._point_covariance(self.state)

    def moments(self):
        """(point_estimate, point_covariance) in one fused dispatch,
        cached until the state changes (see ParticleFilter.moments)."""
        if self._moments_cache is None:
            self._moments_cache = self._moments(self.state)
        return self._moments_cache

    @property
    def means(self):
        return self.state.means

    @property
    def covariances(self):
        return self.state.covariances

    @property
    def weights(self):
        return self.state.weights
