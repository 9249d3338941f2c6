"""Sampling-importance-resampling particle filter.

One functional core over an explicit :class:`PFState` pytree replaces the
reference's CPU/GPU class pair (/root/reference/filter/particle.py:9-114
and :117-327): ``vmap`` over the particle axis gives the accelerator
batching the reference built from numba-CUDA gufuncs, and the same code
runs on CPU for parity tests. The full predict/update/resample step fuses
into a single ``jit`` so a control-loop iteration is one device dispatch
(the reference performs >=4 host<->device syncs per control step,
SURVEY.md section 3.1).

API parity: the :class:`ParticleFilter` shell keeps the reference's
six-method surface (ctor, predict, update, resample, point_estimate,
point_covariance).
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from gpu_se_tpu import pytree

from gpu_se_tpu.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu.filters.resampling import systematic_resample


@pytree.dataclass
class PFState:
    """Particle-filter state: particles (N, Nx), weights (N,), PRNG key."""

    particles: jax.Array
    weights: jax.Array
    key: jax.Array

    @property
    def n_particles(self) -> int:
        return self.particles.shape[0]


# ----------------------------------------------------------------------
# Functional core. `f`, `g` are static (closed over at trace time):
#   f(x, u, dt) -> state delta   (dt premultiplied, reference convention,
#                                 /root/reference/filter/particle.py:66)
#   g(x, u) -> predicted output
# ----------------------------------------------------------------------
def init(
    key: jax.Array, n_particles: int, x0: GaussianSum, dtype=jnp.float32
) -> PFState:
    key, sub = jax.random.split(key)
    particles = x0.draw(sub, (n_particles,)).astype(dtype)
    weights = jnp.full((n_particles,), 1.0 / n_particles, dtype=dtype)
    return PFState(particles=particles, weights=weights, key=key)


def predict(
    state: PFState, u: jax.Array, dt, f: Callable, state_pdf: GaussianSum
) -> PFState:
    """x_i += f(x_i, u, dt) + w_i (cf. /root/reference/filter/particle.py:54-67)."""
    key, sub = jax.random.split(state.key)
    deltas = jax.vmap(f, in_axes=(0, None, None))(state.particles, u, dt)
    noise = state_pdf.draw(sub, (state.particles.shape[0],))
    return state.replace(particles=state.particles + deltas + noise, key=key)


def update(
    state: PFState, u: jax.Array, z: jax.Array, g: Callable, measurement_pdf: GaussianSum
) -> PFState:
    """w_i *= p(z - g(x_i, u)) (cf. /root/reference/filter/particle.py:69-83)."""
    ys = jax.vmap(g, in_axes=(0, None))(state.particles, u)
    ws = measurement_pdf.pdf(z - ys)
    return state.replace(weights=state.weights * ws)


def update_stabilized(
    state: PFState, u: jax.Array, z: jax.Array, g: Callable, measurement_pdf: GaussianSum
) -> PFState:
    """Log-space weight update: w_i ∝ exp(log w_i + logpdf_i - max).

    Numerically stable replacement for the linear multiply — the reference
    had to rescale weights by hand to dodge float32 underflow during
    repeated updates (/root/reference/results/gsf_openloop/gsf_power.py;
    SURVEY.md Appendix A). Weights come back normalized; downstream
    resampling/moments are normalization-invariant.
    """
    ys = jax.vmap(g, in_axes=(0, None))(state.particles, u)
    logw = jnp.log(jnp.maximum(state.weights, 1e-38)) + measurement_pdf.logpdf(z - ys)
    logw = logw - jnp.max(logw)
    w = jnp.exp(logw)
    return state.replace(weights=w / jnp.sum(w))


def resample(state: PFState) -> PFState:
    """Systematic resample (cf. /root/reference/filter/particle.py:85-103)."""
    key, sub = jax.random.split(state.key)
    particles, weights = systematic_resample(state.particles, state.weights, sub)
    return PFState(particles=particles, weights=weights, key=key)


def step(
    state: PFState,
    u: jax.Array,
    z: jax.Array,
    dt,
    f: Callable,
    g: Callable,
    state_pdf: GaussianSum,
    measurement_pdf: GaussianSum,
) -> PFState:
    """Fused predict + update + resample — the hot per-control-step op."""
    state = predict(state, u, dt, f, state_pdf)
    state = update(state, u, z, g, measurement_pdf)
    return resample(state)


def point_estimate(state: PFState) -> jax.Array:
    """Weighted mean of the particles, normalized
    (cf. /root/reference/filter/particle.py:105-107 — the reference skips
    normalization because its weights are uniform after resampling; we
    normalize so the estimate is correct mid-cycle too). Blocked
    reduction: a naive f32 dot loses ~2.5% at 2^22 particles
    (ops/reduce.py)."""
    from gpu_se_tpu.ops.reduce import weighted_mean

    return weighted_mean(state.weights, state.particles)


def point_covariance(state: PFState) -> jax.Array:
    """Max singular value of the weighted particle covariance
    (cf. /root/reference/filter/particle.py:109-114)."""
    from gpu_se_tpu.ops.reduce import blocked_sum, weighted_mean

    from gpu_se_tpu.ops.reduce import blocked_outer_sum

    w = state.weights / blocked_sum(state.weights)
    mean = weighted_mean(state.weights, state.particles)
    dist = state.particles - mean
    cov = blocked_outer_sum(dist, dist * w[:, None])
    s = jnp.linalg.svd(cov, compute_uv=False)
    return s[0]


# ----------------------------------------------------------------------
class ParticleFilter:
    """Stateful shell with the reference six-method API.

    One class serves every backend; pass ``device`` to pin placement.
    All methods are jitted with ``f``/``g`` closed over at trace time.
    """

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
        self.f, self.g = f, g
        self.N_particles = int(N_particles)
        self.state_pdf = _as_dist(state_pdf)
        self.measurement_pdf = _as_dist(measurement_pdf)
        x0 = _as_dist(x0)

        key = jax.random.PRNGKey(seed)
        self.state = init(key, self.N_particles, x0)
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

    # -- reference API --------------------------------------------------
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
        """Fused full cycle (one dispatch); not in the reference API."""
        self._set_state(self._step(
            self.state, jnp.asarray(u), jnp.asarray(z), jnp.asarray(dt, jnp.float32),
            state_pdf=self.state_pdf, measurement_pdf=self.measurement_pdf,
        ))

    def point_estimate(self):
        return self._point_estimate(self.state)

    def point_covariance(self):
        return self._point_covariance(self.state)

    def moments(self):
        """(point_estimate, point_covariance) in ONE fused dispatch,
        cached until the filter state changes — the closed-loop harness
        reads the moments every plant substep (sim/harness.py), each
        read otherwise a device dispatch and a transfer to the host; the
        cache makes repeats free and value-identical."""
        if self._moments_cache is None:
            self._moments_cache = self._moments(self.state)
        return self._moments_cache

    # convenience for tests
    @property
    def particles(self):
        return self.state.particles

    @property
    def weights(self):
        return self.state.weights


def _as_dist(d) -> GaussianSum:
    """Accept either a GaussianSum pytree or a stateful shell."""
    if isinstance(d, GaussianSum):
        return d
    return d.dist
