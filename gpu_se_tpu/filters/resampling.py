"""Systematic resampling — the framework's one genuinely parallel-hard op.

The reference implements this three ways: a sequential cumsum walk on CPU
(/root/reference/filter/particle.py:85-103), and on GPU a Torch cumsum via
DLPack plus a hand-written CUDA kernel doing a per-thread bidirectional
scan ("Nicely's algorithm", /root/reference/filter/particle.py:223-263).

Here one XLA formulation serves every backend: the weight cumsum is
turned into integer segment ``ends`` (particle ``k`` parents output
slots ``ends[k-1]+1 .. ends[k]``), and the ancestors follow by a scatter
at each segment start plus a running max — identical output to the
reference CPU walk. The multi-device variant lives in
``gpu_se_tpu.parallel`` (segmented scan + exchange of the ends blocks).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def systematic_positions(n: int, r: jax.Array) -> jax.Array:
    """Stratified positions u_i = (i + r) / n for a single uniform r."""
    i = jnp.arange(n, dtype=jnp.float32)
    return (i + r) / n


def ends_from_weights(weights: jax.Array, r: jax.Array) -> jax.Array:
    """Integer segment ends of systematic resampling.

    Particle ``k`` parents exactly the output slots ``i`` with
    ``(i + r)/n <= cs_k`` and ``(i + r)/n > cs_{k-1}`` (``cs`` the
    normalized cumsum), i.e. slots ``ends[k-1]+1 .. ends[k]`` with
    ``ends[k] = floor(n cs_k - r)``. Returns the (N,) int32 ends,
    nondecreasing and clipped to ``[-1, n-1]``.
    """
    n = weights.shape[0]
    cumsum = jnp.cumsum(weights)
    cumsum = cumsum / cumsum[-1]
    ends = jnp.floor(n * cumsum - r).astype(jnp.int32)
    # A parallel (tree) cumsum can dip by an ulp; a dipped ends entry
    # makes segment boundaries ambiguous, so every formulation (scatter,
    # binary search, the distributed protocols) agrees bitwise only on
    # monotone ends. On a sequential cumsum this is the identity.
    ends = jax.lax.cummax(ends)
    return jnp.clip(ends, -1, n - 1)


def indices_from_ends(ends: jax.Array) -> jax.Array:
    """Ancestor indices from monotone ``ends``: ``idx[i]`` is the smallest
    ``k`` with ``ends[k] >= i``. Scatter each parent ``k`` at its first
    slot ``ends[k-1]+1``, then an inclusive running max fills the rest."""
    n = ends.shape[0]
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), ends[:-1] + 1])
    valid = starts <= ends
    ks = jnp.arange(n, dtype=jnp.int32)
    seed = (
        jnp.zeros(n, jnp.int32)
        .at[jnp.where(valid, starts, n)]
        .max(jnp.where(valid, ks, 0), mode="drop")
    )
    return jax.lax.cummax(seed)


def systematic_resample_indices(weights: jax.Array, r: jax.Array) -> jax.Array:
    """Ancestor indices for systematic resampling.

    Matches the reference CPU semantics exactly
    (/root/reference/filter/particle.py:96-100): ``idx[i]`` is the
    smallest ``k`` such that ``cumsum[k] >= (i + r) / N`` with the cumsum
    normalized by its last entry.

    Parameters
    ----------
    weights : (N,) nonnegative weights (need not be normalized)
    r : scalar in [0, 1)

    Returns
    -------
    (N,) int32 ancestor indices.
    """
    return indices_from_ends(ends_from_weights(weights, r))


def sorted_row_gather(a: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather rows ``a[idx]`` for monotone non-decreasing in-bounds ``idx``.

    Systematic-resampling ancestors are sorted by construction; the gather
    says so (``indices_are_sorted``) and promises in-bounds indices, so
    XLA may pick a windowed lowering and skips the bounds clamp
    (cf. the reference's gather, /root/reference/filter/particle.py:315-316).
    """
    shape = a.shape
    flat = a.reshape(shape[0], -1)
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0,)
    )
    out = jax.lax.gather(
        flat,
        idx[:, None],
        dn,
        slice_sizes=(1, flat.shape[1]),
        indices_are_sorted=True,
        unique_indices=False,
        mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS,
    )
    return out.reshape((idx.shape[0],) + shape[1:])


def systematic_resample(pytree, weights: jax.Array, key: jax.Array):
    """Resample any pytree of (N, ...) arrays along axis 0.

    Returns ``(resampled_pytree, uniform_weights)``. Shared by the
    particle filter (particles) and the GSUKF (means + covariances),
    mirroring the duplicated kernels at
    /root/reference/filter/particle.py:296-316 and gs_ukf.py:409-436.
    Every leaf keeps its dtype.
    """
    n = weights.shape[0]
    r = jax.random.uniform(key, ())
    idx = systematic_resample_indices(weights, r)
    gathered = jax.tree_util.tree_map(lambda a: sorted_row_gather(a, idx), pytree)
    return gathered, jnp.full((n,), 1.0 / n, dtype=weights.dtype)
