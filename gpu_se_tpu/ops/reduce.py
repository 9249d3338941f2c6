"""Accumulation-safe reductions over the particle axis.

A naive float32 dot/sum over N=2^22 terms accumulates sequentially on the
XLA CPU backend: once the running sum is ~1e1 and each increment ~1e-6,
half of every increment rounds away (ulp-starvation) — observed as a 2.5%
error in the PF point estimate at 2^22 particles, with a different wrong
answer per mesh width (different partial-sum grouping). The reference
never hits this only because its moments run on cuBLAS reductions.

``blocked_sum`` does a two-level (pairwise-style) reduction: error grows
like (B + N/B)*eps instead of N*eps. Used by every moment computation
(point_estimate / point_covariance for both filters).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def blocked_sum(x, block: int = 4096):
    """Sum over axis 0 in two levels; exact shape-preserving for the
    remaining axes. Falls back to smaller blocks until one divides N."""
    n = x.shape[0]
    b = min(block, n)
    while n % b:
        b //= 2
    if b <= 1:
        return jnp.sum(x, axis=0)
    xr = x.reshape((n // b, b) + x.shape[1:])
    return jnp.sum(jnp.sum(xr, axis=1), axis=0)


def weighted_mean(weights, x, block: int = 4096):
    """Accumulation-safe sum_i w_i x_i / sum_i w_i over axis 0."""
    total = blocked_sum(weights, block)
    w = (weights / total).reshape((-1,) + (1,) * (x.ndim - 1))
    return blocked_sum(w * x, block)


def blocked_outer_sum(a, b, block: int = 4096):
    """sum_i outer(a_i, b_i) over axis 0 without materializing (N, d, d):
    per-block (b, d1)^T @ (b, d2) matmuls, then a short block sum."""
    n = a.shape[0]
    blk = min(block, n)
    while n % blk:
        blk //= 2
    if blk <= 1:
        return jnp.matmul(a.T, b, precision=jax.lax.Precision.HIGHEST)
    ar = a.reshape(n // blk, blk, a.shape[1])
    br = b.reshape(n // blk, blk, b.shape[1])
    partials = jnp.einsum("kbi,kbj->kij", ar, br,
                          precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(partials, axis=0)
