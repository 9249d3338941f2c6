"""Gaussian-sum (mixture of multivariate Gaussians) distributions.

Functional core: :class:`GaussianSum` is an immutable pytree holding the
mixture parameters plus factors precomputed at construction (Cholesky
factors for sampling, inverse covariances and normalization constants for
the pdf — mirroring the precomputation in
/root/reference/gaussian_sum_dist/MultivariateGaussianSum.py:33-37).

All sampling takes an explicit ``jax.random`` key, so determinism-for-tests
falls out for free: the same key yields the same draws on every backend.
The reference needed a class-level replay cache for that
(/root/reference/gaussian_sum_dist/DeterministicGaussianSum.py:27-65);
here :class:`DeterministicGaussianSum` is a thin shell that replays a
shared lazily-extended stream with identical first-``n``-values semantics.
"""
from __future__ import annotations

import math
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from gpu_se_tpu import pytree

ShapeLike = Union[int, Tuple[int, ...]]

# float32 products in full precision: on GPUs a default-precision f32
# matmul may run in TF32 (~3 decimal digits), which would perturb every
# noise draw and pdf weight relative to the CPU stream.
_HIGHEST = jax.lax.Precision.HIGHEST


@pytree.dataclass
class GaussianSum:
    """Mixture of ``Nd`` multivariate Gaussians over ``R^Nx`` as a pytree.

    Attributes
    ----------
    means : (Nd, Nx) float32
    covariances : (Nd, Nx, Nx) float32
    weights : (Nd,) float32
        Mixture weights (need not be normalized; pdf uses them as given,
        draw normalizes).
    chol : (Nd, Nx, Nx) float32
        Lower Cholesky factors of the covariances (for sampling).
    inv_cov : (Nd, Nx, Nx) float32
        Inverse covariances (for the pdf quadratic form).
    log_const : (Nd,) float32
        ``-Nx/2 log(2 pi) - 1/2 log det(cov)`` per component.
    """

    means: jax.Array
    covariances: jax.Array
    weights: jax.Array
    chol: jax.Array
    inv_cov: jax.Array
    log_const: jax.Array

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, means, covariances, weights, dtype=jnp.float32) -> "GaussianSum":
        """Build a mixture, precomputing factors in float64 on host."""
        means64 = np.atleast_2d(np.asarray(means, dtype=np.float64))
        covs64 = np.asarray(covariances, dtype=np.float64)
        if covs64.ndim == 2:
            covs64 = covs64[None]
        w64 = np.atleast_1d(np.asarray(weights, dtype=np.float64))
        nd, nx = means64.shape
        chol = np.linalg.cholesky(covs64)
        inv_cov = np.linalg.inv(covs64)
        _, logdet = np.linalg.slogdet(covs64)
        log_const = -0.5 * nx * math.log(2.0 * math.pi) - 0.5 * logdet
        return cls(
            means=jnp.asarray(means64, dtype),
            covariances=jnp.asarray(covs64, dtype),
            weights=jnp.asarray(w64, dtype),
            chol=jnp.asarray(chol, dtype),
            inv_cov=jnp.asarray(inv_cov, dtype),
            log_const=jnp.asarray(log_const, dtype),
        )

    # ------------------------------------------------------------------
    @property
    def n_components(self) -> int:
        return self.means.shape[0]

    @property
    def n_dim(self) -> int:
        return self.means.shape[1]

    # ------------------------------------------------------------------
    def pdf(self, x: jax.Array) -> jax.Array:
        """Mixture pdf at a batch of points.

        Matches the batched quadratic-form formulation of
        /root/reference/gaussian_sum_dist/MultivariateGaussianSum.py:39-63:
        ``sum_d w_d c_d exp(-1/2 e_d^T S_d^{-1} e_d)``.

        Parameters
        ----------
        x : (..., Nx) array

        Returns
        -------
        (...,) array of pdf values.
        """
        x = jnp.atleast_2d(x)
        es = x[..., None, :] - self.means  # (..., Nd, Nx)
        quad = jnp.einsum("...di,dij,...dj->...d", es, self.inv_cov, es,
                          precision=_HIGHEST)
        comp = jnp.exp(self.log_const - 0.5 * quad)  # (..., Nd)
        return jnp.sum(self.weights * comp, axis=-1)

    def pdf_t(self, x: jax.Array) -> jax.Array:
        """Lanes-last mixture pdf: ``x`` is ``(Nx, ...)`` with the batch
        minor; returns ``(...)``.

        Same mixture as :meth:`pdf` with the quadratic form unrolled
        over the (tiny, static) component and state dims as pure
        elementwise ops — built for bulk lanes-last consumers (the
        structure-of-arrays PF step, filters/particle_tiled.py). The
        contraction order matches
        ``(e @ inv_cov) . e`` row-major, so values can differ from
        :meth:`pdf`'s einsum by association ulps.
        """
        total = None
        for d in range(self.n_components):
            es = [x[i] - self.means[d, i] for i in range(self.n_dim)]
            quad = None
            for i in range(self.n_dim):
                acc = None
                for j in range(self.n_dim):
                    term = self.inv_cov[d, j, i] * es[j]
                    acc = term if acc is None else acc + term
                t = es[i] * acc
                quad = t if quad is None else quad + t
            comp = self.weights[d] * jnp.exp(self.log_const[d] - 0.5 * quad)
            total = comp if total is None else total + comp
        return total

    def logpdf(self, x: jax.Array) -> jax.Array:
        """Numerically-stable log mixture pdf (log-sum-exp over components).

        The reference works in linear probability space and has to rescale
        weights to dodge float32 underflow
        (/root/reference/results/gsf_openloop/gsf_power.py); working in
        log space removes that failure mode.
        """
        x = jnp.atleast_2d(x)
        es = x[..., None, :] - self.means
        quad = jnp.einsum("...di,dij,...dj->...d", es, self.inv_cov, es,
                          precision=_HIGHEST)
        logs = self.log_const - 0.5 * quad + jnp.log(self.weights)
        return jax.scipy.special.logsumexp(logs, axis=-1)

    # ------------------------------------------------------------------
    def draw(self, key: jax.Array, shape: ShapeLike = (1,)) -> jax.Array:
        """Draw samples: categorical component choice + ``mean + L @ eps``.

        Replaces the reference's multinomial-bincount + per-component
        ``multivariate_normal`` loop
        (/root/reference/gaussian_sum_dist/MultivariateGaussianSum.py:65-97)
        with a fully vectorized, jit-able draw: per-sample categorical
        component indices and a batched triangular matmul.

        Parameters
        ----------
        key : PRNG key
        shape : int or tuple
            Leading output shape.

        Returns
        -------
        (*shape, Nx) float32 array.
        """
        if not isinstance(shape, tuple):
            shape = (shape,)
        size = int(np.prod(shape)) if shape else 1
        kc, kn = jax.random.split(key)
        logits = jnp.log(self.weights)
        comp = jax.random.categorical(kc, logits, shape=(size,))
        eps = jax.random.normal(kn, (size, self.n_dim), dtype=self.means.dtype)
        # Component selection via one-hot matmuls instead of per-sample
        # (Nd, Nx, Nx) gathers: Nd is tiny (2 in the canonical rig), so
        # every component's affine is computed and the right one selected.
        onehot = jax.nn.one_hot(comp, self.n_components, dtype=eps.dtype)
        scaled = jnp.einsum("nj,dij->ndi", eps, self.chol, precision=_HIGHEST)
        # sum over components as a broadcast-multiply-reduce rather than a
        # batched einsum with a tiny contraction (see ops/smallmat.bmm_small)
        out = jnp.matmul(onehot, self.means, precision=_HIGHEST) + jnp.sum(
            onehot[:, :, None] * scaled, axis=1)
        return out.reshape(shape + (self.n_dim,))

    def draw_t(self, key: jax.Array, size: int) -> jax.Array:
        """Lanes-last draw: ``(Nx, size)`` with the big axis minor.

        Same distribution as :meth:`draw` but a DIFFERENT stream mapping
        (eps is generated transposed), built for bulk structure-of-arrays
        consumers (the PF step, the GSUKF sigma noise). Every op keeps
        ``size`` as the minor axis: the per-component affines are
        (Nx, Nx) @ (Nx, size) matmuls and the categorical combine is a
        broadcast-multiply-reduce over the tiny component axis.
        """
        kc, kn = jax.random.split(key)
        eps = jax.random.normal(kn, (self.n_dim, size),
                                dtype=self.means.dtype)
        if self.n_components == 2:
            # two-component fast path (the canonical rig): categorical
            # collapses to one uniform compare and the combine to one
            # select
            u = jax.random.uniform(kc, (size,), dtype=self.means.dtype)
            p0 = self.weights[0] / (self.weights[0] + self.weights[1])
            a = self.means[0][:, None] + jnp.matmul(
                self.chol[0], eps, precision=_HIGHEST)
            b = self.means[1][:, None] + jnp.matmul(
                self.chol[1], eps, precision=_HIGHEST)
            return jnp.where((u < p0)[None, :], a, b)
        logits = jnp.log(self.weights)
        comp = jax.random.categorical(kc, logits, shape=(size,))
        scaled = jnp.stack([
            jnp.matmul(self.chol[d], eps, precision=_HIGHEST)
            for d in range(self.n_components)
        ])                                            # (Nd, Nx, size)
        onehot = (comp[None, :] ==
                  jnp.arange(self.n_components)[:, None]
                  ).astype(eps.dtype)                 # (Nd, size)
        mean_term = jnp.matmul(self.means.T, onehot,
                               precision=_HIGHEST)   # (Nx, size)
        noise = jnp.sum(onehot[:, None, :] * scaled, axis=0)
        return mean_term + noise

    # ------------------------------------------------------------------
    def mean(self) -> jax.Array:
        """Mixture mean (weights normalized)."""
        w = self.weights / jnp.sum(self.weights)
        return w @ self.means

    def covariance(self) -> jax.Array:
        """Mixture covariance (law of total covariance)."""
        w = self.weights / jnp.sum(self.weights)
        mu = w @ self.means
        d = self.means - mu
        return jnp.einsum("d,dij->ij", w, self.covariances) + jnp.einsum(
            "d,di,dj->ij", w, d, d
        )


# ======================================================================
# Stateful shells with the reference ctor/API shape
# ======================================================================
class MultivariateGaussianSum:
    """Stateful shell with the reference's constructor and method surface.

    ``library=`` is accepted and ignored — under JAX one code path serves
    every backend (cf. the numpy/cupy switch at
    /root/reference/gaussian_sum_dist/MultivariateGaussianSum.py:27-37).
    Each ``draw`` call advances an internal PRNG key; pass ``seed`` for
    reproducibility.
    """

    def __init__(self, means, covariances, weights, library=None, seed: int = 0):
        del library
        self.dist = GaussianSum.create(means, covariances, weights)
        self._key = jax.random.PRNGKey(seed)
        # Reference-compatible attribute aliases
        self.means = self.dist.means
        self.covariances = self.dist.covariances
        self.weights = self.dist.weights

    @property
    def _Nd(self) -> int:
        return self.dist.n_components

    @property
    def _Nx(self) -> int:
        return self.dist.n_dim

    def pdf(self, x):
        return self.dist.pdf(x)

    def logpdf(self, x):
        return self.dist.logpdf(x)

    def next_key(self) -> jax.Array:
        self._key, sub = jax.random.split(self._key)
        return sub

    def draw(self, shape: ShapeLike = (1,)):
        return self.dist.draw(self.next_key(), shape)


class DeterministicGaussianSum(MultivariateGaussianSum):
    """Replay-deterministic variant for CPU<->accelerator parity tests.

    Reproduces the reference semantics exactly: all instances share a
    single lazily-extended stream of scalar draws, and ``draw(shape)``
    returns the *first* ``prod(shape) * Nx`` values of the stream
    (cf. /root/reference/gaussian_sum_dist/DeterministicGaussianSum.py:45-65)
    — so two instances (e.g. one driving a CPU filter and one a GPU
    filter) see byte-identical noise.
    """

    _values = np.array([], dtype=np.float32)
    # Lazily created so importing the package never initializes a backend.
    _stream_key = None

    def __init__(self, means, covariances, weights, library=None, seed: int = 0):
        super().__init__(means, covariances, weights, library, seed)

    @classmethod
    def reset(cls):
        cls._values = np.array([], dtype=np.float32)
        cls._stream_key = None

    def draw(self, shape: ShapeLike = (1,)):
        if not isinstance(shape, tuple):
            shape = (shape,)
        size = int(np.prod(shape)) * self._Nx
        cls = DeterministicGaussianSum
        if cls._values.size < size:
            if cls._stream_key is None:
                cls._stream_key = jax.random.PRNGKey(1234)
            need = size - cls._values.size
            n_draw = -(-need // self._Nx)  # ceil
            cls._stream_key, sub = jax.random.split(cls._stream_key)
            drawn = np.asarray(self.dist.draw(sub, (n_draw,))).ravel()[:need]
            cls._values = np.hstack([cls._values, drawn.astype(np.float32)])
        out = cls._values[:size].reshape(shape + (self._Nx,))
        return jnp.asarray(np.squeeze(out))
