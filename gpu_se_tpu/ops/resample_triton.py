"""Fused systematic-resample search + gather for GPUs (Pallas, Triton route).

The original project resampled on its GPU in three stages: a cumsum of
the weights, one thread per output particle binary-searching it, and a
fancy-indexing gather of the rows (/root/reference/filter/particle.py:
223-263, 296-316). This kernel is the last two stages fused over a
structure-of-arrays state: each program takes ``block`` output slots,
finds every slot's ancestor by a branchless binary search of the integer
segment ``ends`` (``filters/resampling.ends_from_weights``), and gathers
the ``nx`` state rows of those ancestors. Searching the integer ends (not
the float cumsum) makes the ancestors bitwise equal to the XLA path,
``filters/resampling.indices_from_ends``.

Against the XLA path it saves the scatter, the running max and the
materialized index vector between them and the gather.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

BLOCK = 1024    # output slots per program


def _kernel(ends_ref, x_ref, out_ref, anc_ref, *, n, nx, block, steps):
    start = pl.program_id(0) * block
    slots = start + jnp.arange(block, dtype=jnp.int32)
    # lower bound: pos = #{k : ends[k] < slot}, by binary lifting over
    # power-of-two steps (2^steps - 1 >= n, so every count is reachable)
    pos = jnp.zeros((block,), jnp.int32)
    for s in reversed(range(steps)):
        probe = pos + ((1 << s) - 1)
        e = plt.load(ends_ref.at[jnp.minimum(probe, n - 1)])
        pos = jnp.where((probe < n) & (e < slots), pos + (1 << s), pos)
    # slots past n (the padded tail) count every entry; clamp them back
    anc = jnp.minimum(pos, n - 1)
    plt.store(anc_ref.at[pl.ds(start, block)], anc)
    for d in range(nx):
        plt.store(out_ref.at[d, pl.ds(start, block)], plt.load(x_ref.at[d, anc]))


@functools.partial(jax.jit, static_argnames=("block", "interpret"))
def resample_gather(x: jax.Array, ends: jax.Array, *, block: int = BLOCK,
                    interpret: bool = False):
    """Ancestors and resampled state from monotone integer ``ends``.

    Parameters
    ----------
    x : (nx, N) state, one row per dimension
    ends : (N,) int32 nondecreasing segment ends, ``ends[-1] == N - 1``
    block : output slots per program (a power of two)
    interpret : run the kernel in the Pallas interpreter (CPU tests)

    Returns ``(x[:, anc] (nx, N), anc (N,) int32)``.
    """
    nx, n = x.shape
    n_pad = pl.cdiv(n, block) * block
    kernel = functools.partial(
        _kernel, n=n, nx=nx, block=block, steps=n.bit_length())
    out, anc = pl.pallas_call(
        kernel,
        out_shape=(
            jax.ShapeDtypeStruct((nx, n_pad), x.dtype),
            jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        ),
        grid=(n_pad // block,),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="resample_search_gather",
    )(ends, x)
    if n_pad != n:
        out, anc = out[:, :n], anc[:n]
    return out, anc
