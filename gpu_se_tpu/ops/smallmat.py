"""Batched small-matrix kernels (n <= ~8) as unrolled elementwise ops.

XLA's batched ``jnp.linalg.cholesky``/``inv`` are built for few large
matrices, not huge batches of tiny ones (the GSUKF regime: (N, 5, 5)
covariances, (N, 2, 2) innovation matrices — cf.
/root/reference/filter/gs_ukf.py which used Torch batched kernels for
the same reason). Unrolling the factorization over the static small
dimension turns everything into vectorized elementwise math over the
batch axis, which XLA fuses.
"""
from __future__ import annotations

import jax.numpy as jnp


def bmm_small(a, b):
    """Batched tiny matmul (n, i, k) @ (n, k, j) -> (n, i, j) as a
    broadcast-multiply-reduce: elementwise float32 math (never a
    reduced-precision matmul) that fuses with its neighbours."""
    return jnp.sum(a[:, :, :, None] * b[:, None, :, :], axis=2)


def weighted_outer_sum(a, w, b):
    """einsum('nsx,s,nsy->nxy', a, w, b) as elementwise math."""
    return jnp.sum(
        a[:, :, :, None] * (w[None, :, None, None] * b[:, :, None, :]),
        axis=1,
    )


def weighted_sigma_mean(w, sigmas):
    """einsum('s,nsx->nx', w, sigmas) as elementwise math."""
    return jnp.sum(w[None, :, None] * sigmas, axis=1)


def cholesky_small(covs: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky of a batch of small SPD matrices (..., n, n).

    Unrolled Cholesky-Crout; returns NaN entries for non-PD inputs
    (same contract as jnp.linalg.cholesky).
    """
    n = covs.shape[-1]
    cols = [[None] * n for _ in range(n)]  # cols[i][j] = L[..., i, j]
    for j in range(n):
        s = covs[..., j, j]
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        d = jnp.sqrt(s)
        cols[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s2 = covs[..., i, j]
            for k in range(j):
                s2 = s2 - cols[i][k] * cols[j][k]
            cols[i][j] = s2 * inv_d
    zero = jnp.zeros_like(covs[..., 0, 0])
    rows = [
        jnp.stack([cols[i][j] if j <= i else zero for j in range(n)], axis=-1)
        for i in range(n)
    ]
    return jnp.stack(rows, axis=-2)


def inv_small_jittered(mats: jnp.ndarray, rel_jitter: float = 1e-6) -> jnp.ndarray:
    """Branchless degenerate-safe batched small inverse.

    ``inv_small`` divides by ``det``; a singular (or numerically
    collapsed) matrix yields inf/NaN entries. Where that happens, redo
    with ``rel_jitter * mean(diag) * I`` added — the gain-solve analogue
    of ``_batched_cholesky_jittered`` (filters/gs_ukf.py), standing in
    for the reference CPU path's ``pinv``
    (/root/reference/filter/gs_ukf.py:134).
    """
    n = mats.shape[-1]
    inv0 = inv_small(mats)
    bad = ~jnp.isfinite(inv0).all(axis=(-2, -1), keepdims=True)
    trace = jnp.trace(mats, axis1=-2, axis2=-1)[..., None, None]
    scale = rel_jitter * jnp.abs(trace) / n + jnp.finfo(mats.dtype).tiny
    inv1 = inv_small(mats + scale * jnp.eye(n, dtype=mats.dtype))
    # a doubly-degenerate matrix (zero trace) still inverts to non-finite;
    # zero the gain rather than poison the mean (pinv-of-0 semantics)
    inv1 = jnp.where(jnp.isfinite(inv1), inv1, 0.0)
    return jnp.where(bad, inv1, inv0)


def inv_small(mats: jnp.ndarray) -> jnp.ndarray:
    """Inverse of a batch of small matrices (..., n, n), n in {1, 2, 3};
    falls back to jnp.linalg.inv for larger n."""
    n = mats.shape[-1]
    if n == 1:
        return 1.0 / mats
    if n == 2:
        a, b = mats[..., 0, 0], mats[..., 0, 1]
        c, d = mats[..., 1, 0], mats[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        row0 = jnp.stack([d * inv_det, -b * inv_det], axis=-1)
        row1 = jnp.stack([-c * inv_det, a * inv_det], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    if n == 3:
        m = mats
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
        inv_det = 1.0 / det
        rows = [
            jnp.stack([c00, c10, c20], axis=-1),
            jnp.stack([c01, c11, c21], axis=-1),
            jnp.stack([c02, c12, c22], axis=-1),
        ]
        return jnp.stack(rows, axis=-2) * inv_det[..., None, None]
    return jnp.linalg.inv(mats)


# ----------------------------------------------------------------------
# Lanes-last variants: matrix dims LEADING, batch dims TRAILING.
#
# Keeping the big batch axis LAST makes every elementwise op a unit-
# stride sweep over (..., N) rows; these mirrors of the batched ops index
# the LEADING dims. Whether this or the batch-leading form is faster on
# a given device is a measurement, not an assumption.
# ----------------------------------------------------------------------
def cholesky_small_lanes(covs: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky of (n, n, ...) SPD matrices (matrix dims leading).

    Same unrolled Cholesky-Crout (and NaN contract) as
    :func:`cholesky_small`, identical op order — only the layout differs.
    """
    n = covs.shape[0]
    cols = [[None] * n for _ in range(n)]
    for j in range(n):
        s = covs[j, j]
        for k in range(j):
            s = s - cols[j][k] * cols[j][k]
        d = jnp.sqrt(s)
        cols[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s2 = covs[i, j]
            for k in range(j):
                s2 = s2 - cols[i][k] * cols[j][k]
            cols[i][j] = s2 * inv_d
    zero = jnp.zeros_like(covs[0, 0])
    return jnp.stack([
        jnp.stack([cols[i][j] if j <= i else zero for j in range(n)])
        for i in range(n)
    ])


def inv_small_lanes(mats: jnp.ndarray) -> jnp.ndarray:
    """Inverse of (n, n, ...) matrices (matrix dims leading).

    n in {1, 2} is fully unrolled in the lanes-last layout; larger n
    round-trips through :func:`inv_small` (matrix dims trailing) so any
    measurement dimension works (the reference handles arbitrary ny via
    pinv, /root/reference/filter/gs_ukf.py:134). The transpose cost only
    applies to ny >= 3 models, which are off the hot benchmark path.
    """
    n = mats.shape[0]
    if n == 1:
        return 1.0 / mats
    if n == 2:
        a, b = mats[0, 0], mats[0, 1]
        c, d = mats[1, 0], mats[1, 1]
        det = a * d - b * c
        inv_det = 1.0 / det
        return jnp.stack([
            jnp.stack([d * inv_det, -b * inv_det]),
            jnp.stack([-c * inv_det, a * inv_det]),
        ])
    batched = jnp.moveaxis(jnp.moveaxis(mats, 0, -1), 0, -1)  # (..., n, n)
    out = inv_small(batched)
    return jnp.moveaxis(jnp.moveaxis(out, -1, 0), -1, 0)


def inv_small_jittered_lanes(mats: jnp.ndarray,
                             rel_jitter: float = 1e-6) -> jnp.ndarray:
    """Lanes-layout mirror of :func:`inv_small_jittered`."""
    n = mats.shape[0]
    inv0 = inv_small_lanes(mats)
    bad = ~jnp.isfinite(inv0).all(axis=(0, 1), keepdims=True)
    trace = sum(mats[i, i] for i in range(n))[None, None]
    scale = rel_jitter * jnp.abs(trace) / n + jnp.finfo(mats.dtype).tiny
    eye = jnp.eye(n, dtype=mats.dtype).reshape(
        (n, n) + (1,) * (mats.ndim - 2))
    inv1 = inv_small_lanes(mats + scale * eye)
    inv1 = jnp.where(jnp.isfinite(inv1), inv1, 0.0)
    return jnp.where(bad, inv1, inv0)
