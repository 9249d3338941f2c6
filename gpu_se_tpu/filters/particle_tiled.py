"""Structure-of-arrays particle filter: the fast single-device step.

The state is one ``(nx, N)`` float32 array — a row per state dimension,
the particle axis minor — plus a PRNG key, and it stays in that layout
across steps:

* predict/update run on the ``(nx, N)`` rows directly: the bioreactor
  dynamics/measurement maps are elementwise over the state components
  (models/bioreactor.py), so the same ``xp``-parameterized functions
  apply unchanged;
* the mixture noise rides :meth:`GaussianSum.draw_t` and the
  measurement weighting :meth:`GaussianSum.pdf_t` (both rows-major);
* the resample turns the weights into integer segment ends
  (``resampling.ends_from_weights``) and gathers the state columns of
  the ancestors.

Semantics: identical to ``filters/particle.step`` (predict + update +
systematic resample; cf. /root/reference/filter/particle.py:54-103) up
to two documented stream/association differences: the noise stream is
``draw_t``'s (transposed eps generation, like the GSUKF sigma noise) and
the pdf quadratic form is the unrolled elementwise contraction of
``pdf_t`` (association ulps vs the einsum). Weights are implicitly
uniform between steps (the step always resamples, and a uniform incoming
weight is an exact power-of-two scale of the cumsum — it cannot move a
segment boundary), so the state carries no weight vector.

``tests/test_particle_tiled.py`` pins the step bitwise against a flat
``(N, nx)`` comparator built from the plain reference
(``systematic_resample_indices`` + ``sorted_row_gather``).
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from gpu_se_tpu import pytree
from gpu_se_tpu.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu.filters.resampling import ends_from_weights, indices_from_ends
from gpu_se_tpu.ops.reduce import blocked_sum

RESAMPLE_KERNELS = ("auto", "xla", "triton")


@pytree.dataclass
class SoAPFState:
    """Particle-filter state: ``x`` (nx, N) float32 rows, PRNG ``key``."""

    x: jax.Array
    key: jax.Array

    @property
    def n_particles(self) -> int:
        return self.x.shape[1]


def init(key: jax.Array, n_particles: int, x0: GaussianSum) -> SoAPFState:
    """Initial particles drawn from ``x0`` (the ``draw_t`` stream)."""
    key, sub = jax.random.split(key)
    return SoAPFState(x=x0.draw_t(sub, n_particles), key=key)


def predict_update(
    x: jax.Array, u, z, dt, f: Callable, g: Callable,
    state_pdf: GaussianSum, measurement_pdf: GaussianSum, key: jax.Array,
):
    """Predict + update on the ``(nx, N)`` rows: returns the predicted
    particles ``xn (nx, N)`` and their weights ``w (N,)``.

    Incoming weights are uniform — an exact power-of-two cumsum scale —
    so the multiply is skipped; see the module docstring."""
    n = x.shape[1]
    xn = x + f(x, u, dt) + state_pdf.draw_t(key, n)
    resid = z.reshape(-1, 1).astype(xn.dtype) - g(xn, u)
    return xn, measurement_pdf.pdf_t(resid)


def gather_columns(x: jax.Array, idx: jax.Array) -> jax.Array:
    """``x[:, idx]`` for sorted in-bounds ``idx`` (systematic ancestors)."""
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(0,), collapsed_slice_dims=(1,), start_index_map=(1,))
    return jax.lax.gather(
        x, idx[:, None], dn, slice_sizes=(x.shape[0], 1),
        indices_are_sorted=True,
        mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS,
    )


def _resample_xla(x, ends):
    anc = indices_from_ends(ends)
    return gather_columns(x, anc), anc


def resample(x: jax.Array, weights: jax.Array, r: jax.Array, *,
             kernel: str = "auto", interpret: bool = False):
    """Systematic resample of the ``(nx, N)`` state.

    ``kernel="xla"`` scatters the ancestors and gathers in XLA;
    ``kernel="triton"`` fuses the search and gather into one Pallas
    kernel (ops/resample_triton.py; CUDA GPUs only unless ``interpret``).
    ``"auto"`` picks the kernel where the program is compiled for a CUDA
    GPU — faster end to end at 2^20 and 2^24 particles on an H100
    (PERF.md) — and XLA on every other platform. All return
    ``(x[:, anc], anc)`` with bitwise-equal ancestors.
    """
    from gpu_se_tpu.ops.resample_triton import resample_gather

    def triton(x, ends):
        return resample_gather(x, ends, interpret=interpret)

    ends = ends_from_weights(weights, r)
    if kernel == "auto":
        return jax.lax.platform_dependent(
            x, ends, cuda=triton, default=_resample_xla)
    if kernel == "triton":
        return triton(x, ends)
    if kernel != "xla":
        raise ValueError(f"kernel must be one of {RESAMPLE_KERNELS}: {kernel!r}")
    return _resample_xla(x, ends)


def step(
    state: SoAPFState,
    u: jax.Array,
    z: jax.Array,
    dt,
    f: Callable,
    g: Callable,
    state_pdf: GaussianSum,
    measurement_pdf: GaussianSum,
    *,
    kernel: str = "auto",
) -> SoAPFState:
    """Fused predict + update + resample.

    ``f(x, u, dt) -> dx`` and ``g(x, u) -> y`` take the state as an
    ``(nx, N)`` stacked leading-axis array (the ``xp``-parameterized
    model functions, NOT the per-particle vmapped closures of
    ``particle.step``). ``kernel`` selects the resample path
    (:func:`resample`).
    """
    key, kn, kr = jax.random.split(state.key, 3)
    xn, w = predict_update(
        state.x, u, z, dt, f, g, state_pdf, measurement_pdf, kn)
    r = jax.random.uniform(kr, (), dtype=jnp.float32)
    x_new, _ = resample(xn, w, r, kernel=kernel)
    return SoAPFState(x=x_new, key=key)


def point_estimate(state: SoAPFState) -> jax.Array:
    """Uniform-weight particle mean per dimension (blocked f32 sum,
    ops/reduce.py)."""
    return blocked_sum(state.x.T) / jnp.float32(state.n_particles)
