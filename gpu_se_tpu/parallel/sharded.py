"""Multi-chip particle filtering: GSPMD auto-sharding + explicit shard_map.

Two complementary paths over a 1-D ``Mesh('particles')``:

* :func:`auto_sharded_step` — the *same* functional PF step jitted with
  ``NamedSharding`` constraints. XLA partitions the vmapped f/g
  elementwise work, psums the weight reductions, and all-gathers for the
  resampling gather. With ``jax_threefry_partitionable`` the noise draws
  are bitwise identical to the single-device run, so shard-invariance is
  exact — this is the correctness anchor.

* :func:`shard_map_step` — explicit SPMD: per-shard predict/update, then
  distributed systematic resampling with O(n_local) per-shard memory:
  a fixed-128-slot segmented cumsum (bitwise width-invariant numerics;
  only the (n/128,) segment totals are ever replicated), ancestor
  computation and particle exchange via ppermute rings that rotate one
  shard-sized block at a time between devices. This is the hand-scheduled
  analogue of the reference's CUDA pipeline (torch cumsum + Nicely
  kernel + gather, /root/reference/filter/particle.py:296-316), scaled
  to the >=2^24-particle regime the reference exercised
  (tests/ParallelParticleFilter_test.py:5). Noise is drawn *outside*
  the shard_map with partitionable keys so both paths see identical
  randomness.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from gpu_se_tpu.distributions.gaussian_sum import GaussianSum
from gpu_se_tpu.filters.particle import PFState
from gpu_se_tpu.filters.resampling import sorted_row_gather
from gpu_se_tpu.parallel.mesh import PARTICLE_AXIS


# ----------------------------------------------------------------------
# Path 1: GSPMD auto-sharding of the functional core
# ----------------------------------------------------------------------
def shard_pf_state(state: PFState, mesh: Mesh) -> PFState:
    """Place a PFState with particles/weights sharded over the mesh."""
    psh = NamedSharding(mesh, P(PARTICLE_AXIS))
    rsh = NamedSharding(mesh, P())
    return PFState(
        particles=jax.device_put(state.particles, NamedSharding(mesh, P(PARTICLE_AXIS, None))),
        weights=jax.device_put(state.weights, psh),
        key=jax.device_put(state.key, rsh),
    )


def make_auto_sharded_step(mesh: Mesh, f: Callable, g: Callable):
    """Jit the fused PF step with sharding constraints; XLA inserts the
    collectives (psum for moments, all-gather for the resample gather)."""
    from gpu_se_tpu.filters import particle as pf_core

    p_sh = NamedSharding(mesh, P(PARTICLE_AXIS, None))
    w_sh = NamedSharding(mesh, P(PARTICLE_AXIS))
    r_sh = NamedSharding(mesh, P())

    state_shardings = PFState(particles=p_sh, weights=w_sh, key=r_sh)

    @partial(
        jax.jit,
        in_shardings=(state_shardings, r_sh, r_sh, r_sh, None, None),
        out_shardings=state_shardings,
    )
    def step(state, u, z, dt, state_pdf, measurement_pdf):
        return pf_core.step(state, u, z, dt, f, g, state_pdf, measurement_pdf)

    return step


# ----------------------------------------------------------------------
# Path 2: explicit shard_map SPMD
# ----------------------------------------------------------------------
def _local_predict(particles, u, dt, noise, f):
    deltas = jax.vmap(f, in_axes=(0, None, None))(particles, u, dt)
    return particles + deltas + noise


def _local_update(particles, weights, u, z, g, measurement_pdf):
    ys = jax.vmap(g, in_axes=(0, None))(particles, u)
    return weights * measurement_pdf.pdf(z - ys)


# Canonical segment length for the distributed cumsum. Any mesh width
# whose shard size is a multiple of this sees the SAME f32 summation
# grouping, so resample boundaries are bitwise width-invariant (the
# motivating failure: a width-dependent local-scan + f32-offset grouping
# shifted boundaries at 2^22 degenerate weights and moved the point
# estimate ~3% between widths 2 and 8).
_SEGMENT = 128


def _segmented_ends(weights, r, axis: str):
    """Distributed ``ends`` vector of the inverse systematic-resample
    formulation (cf. filters/resampling.py:52-59), with width-invariant
    numerics and O(n_local) memory.

    The weight cumsum is computed in fixed 128-slot segments: each shard
    scans its own segments locally, all-gathers only the (n/128,) segment
    totals, and rebuilds its slice of the global normalized cumsum as
    ``(inner + offset) / total`` — every f32 rounding is grouped
    identically for every mesh width (and exactly, since segment sums,
    their small cumsum, and the elementwise combine see the same operands
    in the same order regardless of where shard boundaries fall). The
    integer ``ends`` then needs only an exact cross-shard running max to
    finish the monotonization.
    """
    n_local = weights.shape[0]
    s_idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    n_global = n_local * n_shards

    seg = _SEGMENT if (n_local % _SEGMENT == 0) else n_local
    inner = jnp.cumsum(weights.reshape(-1, seg), axis=1)  # per-segment scan
    totals = jax.lax.all_gather(inner[:, -1], axis).reshape(-1)  # (n/seg,)
    co = jnp.cumsum(totals)  # tiny, replicated, identical on every shard
    off = jnp.concatenate([jnp.zeros((1,), co.dtype), co[:-1]])
    total = co[-1]
    nseg_local = n_local // seg
    off_local = jax.lax.dynamic_slice_in_dim(off, s_idx * nseg_local, nseg_local)
    cs = ((inner + off_local[:, None]) / total).reshape(n_local)

    ends = jnp.floor(n_global * cs - r).astype(jnp.int32)
    ends = jax.lax.cummax(ends)
    # cross-shard running max (exact integer ops): prev = max of earlier
    # shards' final ends
    lasts = jax.lax.all_gather(ends[-1], axis)  # (n_shards,)
    prev = jnp.max(
        jnp.where(jnp.arange(n_shards) < s_idx, lasts, jnp.int32(-1))
    )
    ends = jnp.maximum(ends, prev)
    return jnp.clip(ends, -1, n_global - 1), prev


def _ring_perm(n_shards: int):
    # send to the next shard => after k steps shard s holds block (s-k)%W
    return [(i, (i + 1) % n_shards) for i in range(n_shards)]


def _ring_ancestors(ends, prev_end, axis: str):
    """Global ancestor indices for this shard's output slots, from the
    distributed ``ends`` blocks, via a ppermute ring (O(n_local) memory).

    Round k processes source block q=(s-k)%W: particle ``kbase+j`` first
    feeds global slot ``ends[j-1]+1``; the ones landing in this shard's
    slot range are scattered as seeds and an inclusive running max fills
    the rest — the distributed form of the scatter+cummax inverse
    formulation (filters/resampling.py:60-70). The first slot's ancestor
    (whose seed may live on another shard) is recovered exactly as
    ``#{ends < first_slot}``, accumulated ring-wide.
    """
    n_local = ends.shape[0]
    s_idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    n_global = n_local * n_shards
    slot0 = s_idx * n_local
    perm = _ring_perm(n_shards)

    # boundary value feeding each block's first element: the previous
    # block's final (monotonized) ends — already computed exactly as
    # ``prev_end`` on the OWNER of each block, so circulate it alongside.
    seed = jnp.zeros((n_local,), jnp.int32)
    cnt0 = jnp.zeros((), jnp.int32)
    ks = jnp.arange(n_local, dtype=jnp.int32)

    def round_body(rnd, carry):
        carry_ends, carry_prev, seed, cnt0 = carry
        q = (s_idx - rnd) % n_shards
        kbase = q * n_local
        fs = jnp.concatenate([carry_prev[None], carry_ends[:-1]]) + 1
        valid = fs <= carry_ends  # particle parents >= 1 slot
        tgt = fs - slot0
        tgt = jnp.where(valid & (tgt >= 0) & (tgt < n_local), tgt, n_local)
        seed = seed.at[tgt].max(kbase + ks, mode="drop")
        cnt0 = cnt0 + jnp.sum((carry_ends < slot0).astype(jnp.int32))
        # one extra rotation on the final round returns the block to its
        # owner; a fori_loop (vs Python unrolling) keeps XLA's buffer
        # assignment at one live block instead of one per round
        carry_ends = jax.lax.ppermute(carry_ends, axis, perm)
        carry_prev = jax.lax.ppermute(carry_prev, axis, perm)
        return carry_ends, carry_prev, seed, cnt0

    _, _, seed, cnt0 = jax.lax.fori_loop(
        0, n_shards, round_body, (ends, prev_end, seed, cnt0)
    )
    seed = seed.at[0].max(cnt0)
    anc = jax.lax.cummax(seed)
    return jnp.clip(anc, 0, n_global - 1)


def _ring_gather(pytree, ancestors, axis: str):
    """Gather globally-indexed rows from the sharded pool via a ppermute
    ring: each round rotates one O(n_local) block through every shard and
    copies the rows whose (sorted) ancestors fall in that block — the
    segmented exchange SURVEY section 7 calls for, replacing the
    all-gather of the full pool (O(n_global) live bytes per shard)."""
    n_local = ancestors.shape[0]
    s_idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    perm = _ring_perm(n_shards)
    ancestors = jax.lax.optimization_barrier(ancestors)

    out0 = jax.tree_util.tree_map(
        lambda a: jnp.zeros((n_local,) + a.shape[1:], a.dtype), pytree
    )

    def round_body(rnd, carry):
        blocks, out = carry
        q = (s_idx - rnd) % n_shards
        lo = q * n_local
        in_blk = (ancestors >= lo) & (ancestors < lo + n_local)
        # clipped local indices stay monotone => sorted-gather lowering
        li = jnp.clip(ancestors - lo, 0, n_local - 1)

        def take_block(args):
            blocks_, out_ = args
            def leaf(c, o):
                g = sorted_row_gather(c, li)
                m = in_blk.reshape((-1,) + (1,) * (o.ndim - 1))
                return jnp.where(m, g, o)
            return jax.tree_util.tree_map(leaf, blocks_, out_)

        # data-dependent skip: no collectives inside, so a per-shard
        # divergent predicate is safe under shard_map
        out = jax.lax.cond(
            jnp.any(in_blk), take_block, lambda args: args[1], (blocks, out)
        )
        # rotate every round (the last rotation returns blocks home); the
        # fori_loop keeps one live visiting block instead of one per round
        blocks = jax.tree_util.tree_map(
            lambda a: jax.lax.ppermute(a, axis, perm), blocks
        )
        return blocks, out

    _, out = jax.lax.fori_loop(0, n_shards, round_body, (pytree, out0))
    return out


# ----------------------------------------------------------------------
# Compact -> block-range exchange -> one local merge.
#
# The rings above move EVERY block through EVERY device (O(W * n_local)
# bytes and W sequential scatter rounds). This protocol exploits two
# structural facts of systematic resampling:
#
# 1. Only SURVIVORS (entries with ``ends[k] > ends[k-1]``) can be
#    ancestors, and their covered-slot intervals [first_k, last_k] =
#    [ends[k-1]+1, ends[k]] partition the global slot space.
# 2. A destination shard's n_local slots therefore intersect a set of
#    survivors that (a) numbers at most n_local (each covers >=1 of its
#    slots) and (b) forms one contiguous run per source shard.
#
# So the exchange is a RAGGED ALL-TO-ALL of contiguous survivor runs:
# O(n_local) received rows per device, O(boundary) bytes on the wire in
# the non-adversarial regimes (survivors destined to their own shard
# never transit). After the exchange each shard holds a sorted compacted
# payload covering exactly its slot range and finishes with ONE local
# merge (seed scatter + cummax). Every stage is exact integer arithmetic
# on the width-invariant ``_segmented_ends`` output, so results are
# bitwise equal to the ring protocol.
#
# ``lax.ragged_all_to_all`` has no XLA:CPU lowering, so the virtual-mesh
# tests run a ppermute-ring EMULATION of the same exchange that produces
# a bitwise-identical receive buffer (same runs, same offsets); the
# collective choice is a lowering detail, not a semantic one.
# ----------------------------------------------------------------------
_IBIG = jnp.int32(2**30)     # int pad: > any global slot index


def _compact_survivors(packed, ends, prev):
    """Shard-local survivor compaction.

    Returns ``(rows, ends, first)`` with survivors dense at the front in
    ends order (strictly increasing) and int pads of ``_IBIG`` beyond."""
    n_local = ends.shape[0]
    prev_ends = jnp.concatenate([prev[None], ends[:-1]])
    keep = ends > prev_ends
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, pos, n_local)
    surv_rows = jnp.zeros_like(packed).at[tgt].set(packed, mode="drop")
    surv_ends = jnp.full((n_local,), _IBIG).at[tgt].set(ends, mode="drop")
    surv_first = jnp.full((n_local,), _IBIG).at[tgt].set(
        prev_ends + 1, mode="drop")
    return surv_rows, surv_ends, surv_first


def _send_windows(surv_ends, surv_first, n_local, n_shards):
    """Per-destination contiguous run [lo, lo+size) of local survivors
    whose slot interval intersects that destination's slot range.

    ``lo = #{last < range_start}`` drops survivors wholly before the
    range; ``hi = #{first < range_end}`` keeps those starting before its
    end. Both arrays are sorted (strict ends order; _IBIG pads), so each
    is one searchsorted."""
    starts = (jnp.arange(n_shards, dtype=jnp.int32) * n_local).astype(
        surv_ends.dtype)
    nl = jnp.asarray(n_local, surv_ends.dtype)
    lo = jnp.searchsorted(surv_ends, starts, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(surv_first, starts + nl,
                          side="left").astype(jnp.int32)
    return lo, hi - lo


def _exchange_ragged(surv_rows, surv_meta, in_off, send_sz, out_off,
                     recv_sz, axis: str):
    """The collective exchange: one ragged all-to-all per buffer (rows
    f32, meta int32). Unwritten receive entries keep the init values, so
    the int pads double as the validity mask."""
    rows = jax.lax.ragged_all_to_all(
        surv_rows, jnp.zeros_like(surv_rows),
        in_off, send_sz, out_off, recv_sz, axis_name=axis)
    meta = jax.lax.ragged_all_to_all(
        surv_meta, jnp.full_like(surv_meta, _IBIG),
        in_off, send_sz, out_off, recv_sz, axis_name=axis)
    return rows, meta


def _exchange_ring(surv_rows, surv_meta, sizes_mat, off_mat, axis: str):
    """CPU-testable ppermute-ring emulation of :func:`_exchange_ragged`:
    rotates the survivor blocks and copies each visiting block's run for
    THIS shard to the same receive offsets the ragged collective would
    use — the receive buffers are bitwise identical."""
    n_local = surv_rows.shape[0]
    s_idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    perm = _ring_perm(n_shards)
    slot0 = s_idx * n_local

    my_sizes = sizes_mat[:, s_idx]          # (W,) run length by source
    my_offs = off_mat[:, s_idx]             # (W,) receive offset by source
    out_rows = jnp.zeros_like(surv_rows)
    out_meta = jnp.full_like(surv_meta, _IBIG)
    i = jnp.arange(n_local, dtype=jnp.int32)

    def round_body(rnd, carry):
        vis_rows, vis_meta, out_rows, out_meta = carry
        q = (s_idx - rnd) % n_shards
        lo = jnp.searchsorted(vis_meta[:, 0], slot0,
                              side="left").astype(jnp.int32)
        size = jnp.take(my_sizes, q)
        tgt = jnp.where((i >= lo) & (i < lo + size),
                        jnp.take(my_offs, q) + i - lo, n_local)
        out_rows = out_rows.at[tgt].set(vis_rows, mode="drop")
        out_meta = out_meta.at[tgt].set(vis_meta, mode="drop")
        vis_rows = jax.lax.ppermute(vis_rows, axis, perm)
        vis_meta = jax.lax.ppermute(vis_meta, axis, perm)
        return vis_rows, vis_meta, out_rows, out_meta

    _, _, out_rows, out_meta = jax.lax.fori_loop(
        0, n_shards, round_body, (surv_rows, surv_meta, out_rows, out_meta)
    )
    return out_rows, out_meta


def _merge_received_xla(recv_rows, recv_ends, recv_first, slot0, n_local):
    """One local merge: received survivor i seeds local slot
    ``first_i - slot0`` (the boundary survivor clips to 0 — it is the
    unique one with first < slot0), cummax fills coverage, one sorted
    row gather materializes the output — the per-shard form of the
    scatter+cummax inverse formulation (filters/resampling.py)."""
    valid = recv_ends < _IBIG
    j0 = jnp.clip(recv_first - slot0, 0, n_local - 1)
    tgt = jnp.where(valid, j0, n_local)
    seed = jnp.full((n_local,), jnp.int32(-1)).at[tgt].max(
        jnp.arange(n_local, dtype=jnp.int32), mode="drop")
    p = jax.lax.cummax(seed)
    return sorted_row_gather(recv_rows, jnp.clip(p, 0, n_local - 1))


def _pack_rows(pytree):
    """Flatten a pytree of (n, ...) leaves into one (n, cols) float32
    payload, plus what :func:`_unpack_rows` needs to invert it."""
    leaves, treedef = jax.tree_util.tree_flatten(pytree)
    n = leaves[0].shape[0]
    mats = [leaf.reshape(n, -1).astype(jnp.float32) for leaf in leaves]
    meta = (treedef, [leaf.shape for leaf in leaves],
            [leaf.dtype for leaf in leaves])
    return jnp.concatenate(mats, axis=1) if len(mats) > 1 else mats[0], meta


def _unpack_rows(packed, meta):
    treedef, shapes, dtypes = meta
    out, col = [], 0
    for shape, dtype in zip(shapes, dtypes):
        width = math.prod(shape[1:])
        out.append(packed[:, col:col + width].reshape(shape).astype(dtype))
        col += width
    return jax.tree_util.tree_unflatten(treedef, out)


def _distributed_systematic_resample_a2a(
    pytree, weights, r, axis: str, *, exchange: str = "ragged",
):
    """Compact -> block-range exchange -> one local merge (see the
    section comment above). Bitwise-equal to
    :func:`_distributed_systematic_resample` for any weights.

    ``exchange``: "ragged" (``lax.ragged_all_to_all``) or "ring"
    (ppermute emulation; any backend, including the CPU mesh)."""
    packed, meta = _pack_rows(pytree)
    n_local = weights.shape[0]
    s_idx = jax.lax.axis_index(axis)
    n_shards = jax.lax.axis_size(axis)
    n_global = n_local * n_shards
    slot0 = s_idx * n_local

    ends, prev = _segmented_ends(weights, r, axis)
    surv_rows, surv_ends, surv_first = _compact_survivors(packed, ends, prev)
    in_off, send_sz = _send_windows(surv_ends, surv_first, n_local, n_shards)

    sizes_mat = jax.lax.all_gather(send_sz, axis)       # (W, W) [src, dst]
    csum = jnp.cumsum(sizes_mat, axis=0)
    off_mat = csum - sizes_mat                          # exclusive by src
    surv_meta = jnp.stack([surv_ends, surv_first], axis=1)

    if exchange == "ragged":
        out_off = off_mat[s_idx]
        recv_sz = sizes_mat[:, s_idx]
        recv_rows, recv_meta = _exchange_ragged(
            surv_rows, surv_meta, in_off, send_sz, out_off, recv_sz, axis)
    else:
        recv_rows, recv_meta = _exchange_ring(
            surv_rows, surv_meta, sizes_mat, off_mat, axis)

    new_packed = _merge_received_xla(
        recv_rows, recv_meta[:, 0], recv_meta[:, 1], slot0, n_local)
    new_tree = _unpack_rows(new_packed, meta)
    new_weights = jnp.full((n_local,), 1.0 / n_global, dtype=weights.dtype)
    return new_tree, new_weights


def _distributed_systematic_resample(pytree, weights, r, axis: str):
    """Systematic resample across shards of any pytree of (n_local, ...)
    arrays (particles for the PF; (means, covariances) for the GSUKF —
    the analogue of /root/reference/filter/gs_ukf.py:409-436).

    Memory-scalable: per-shard live bytes stay O(n_global / n_shards).
    The only O(n_global) objects ever resident are the (n/128,) segment
    totals. Three stages, all exact int32 after the segmented cumsum:

    1. :func:`_segmented_ends` — width-invariant distributed cumsum ->
       integer ``ends`` (small all-gathers only);
    2. :func:`_ring_ancestors` — ancestor indices via a ppermute ring
       over the ``ends`` blocks;
    3. :func:`_ring_gather` — particle exchange via a ppermute ring over
       the particle blocks (each shard keeps one visiting block live).

    Bitwise width-invariance holds whenever every width's shard size is a
    multiple of 128 (pinned at 2^23/2^24 in tests/test_sharding.py).
    """
    n_local = weights.shape[0]
    n_shards = jax.lax.axis_size(axis)
    n_global = n_local * n_shards

    ends, prev_end = _segmented_ends(weights, r, axis)
    ancestors = _ring_ancestors(ends, prev_end, axis)
    new_tree = _ring_gather(pytree, ancestors, axis)
    new_weights = jnp.full((n_local,), 1.0 / n_global, dtype=weights.dtype)
    return new_tree, new_weights


def _exchange_for(resample_impl: str, a2a_names: dict):
    """None for the ring protocol ("xla"), else the a2a exchange kind."""
    if resample_impl == "xla":
        return None
    if resample_impl not in a2a_names:
        raise ValueError(
            f"resample_impl must be 'xla' or one of {sorted(a2a_names)}: "
            f"{resample_impl!r}")
    return a2a_names[resample_impl]


def make_shard_map_step(mesh: Mesh, f: Callable, g: Callable,
                        axis: str = PARTICLE_AXIS,
                        resample_impl: str = "xla"):
    """Fused sharded PF step with hand-written collectives.

    Noise/uniform draws happen outside the shard_map with partitionable
    keys, so results are bitwise identical to the single-device step
    whenever XLA keeps the elementwise math in the same order.

    ``resample_impl``: "xla" (scatter+ring, any pytree) or the
    compact/exchange/merge protocol: "a2a_xla" (``lax.ragged_all_to_all``
    exchange) or "a2a_ring" (ppermute-emulated exchange, any backend).
    All are bitwise-equal (integer ``ends`` merge domain).
    """
    exchange = _exchange_for(resample_impl, {"a2a_xla": "ragged",
                                             "a2a_ring": "ring"})

    def step(state: PFState, u, z, dt, state_pdf: GaussianSum,
             measurement_pdf: GaussianSum) -> PFState:
        n = state.particles.shape[0]
        key, k_noise, k_r = jax.random.split(state.key, 3)
        noise = state_pdf.draw(k_noise, (n,))
        r = jax.random.uniform(k_r, ())

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(
                P(axis, None), P(axis), P(), P(), P(), P(axis, None), P(),
            ),
            out_specs=(P(axis, None), P(axis)),
            check_vma=False,
        )
        def sharded(particles, weights, u, z, dt, noise, r):
            particles = _local_predict(particles, u, dt, noise, f)
            weights = _local_update(particles, weights, u, z, g, measurement_pdf)
            if exchange is None:
                particles, weights = _distributed_systematic_resample(
                    particles, weights, r, axis
                )
            else:
                particles, weights = _distributed_systematic_resample_a2a(
                    particles, weights, r, axis, exchange=exchange
                )
            return particles, weights

        particles, weights = sharded(
            state.particles, state.weights, u, z,
            jnp.asarray(dt, state.particles.dtype), noise, r,
        )
        return PFState(particles=particles, weights=weights, key=key)

    p_sh = NamedSharding(mesh, P(axis, None))
    w_sh = NamedSharding(mesh, P(axis))
    r_sh = NamedSharding(mesh, P())
    state_shardings = PFState(particles=p_sh, weights=w_sh, key=r_sh)
    return jax.jit(
        step,
        in_shardings=(state_shardings, r_sh, r_sh, None, None, None),
        out_shardings=state_shardings,
    )


# ----------------------------------------------------------------------
# GSUKF sharding: the same particle-axis story over the Gaussian bank
# ----------------------------------------------------------------------
def shard_gsukf_state(state, mesh: Mesh):
    """Place a GSUKFState with the bank axis sharded over the mesh."""
    from gpu_se_tpu.filters.gs_ukf import GSUKFState

    return GSUKFState(
        means=jax.device_put(state.means, NamedSharding(mesh, P(PARTICLE_AXIS, None))),
        covariances=jax.device_put(
            state.covariances, NamedSharding(mesh, P(PARTICLE_AXIS, None, None))
        ),
        weights=jax.device_put(state.weights, NamedSharding(mesh, P(PARTICLE_AXIS))),
        key=jax.device_put(state.key, NamedSharding(mesh, P())),
    )


def make_auto_sharded_gsukf_step(mesh: Mesh, f: Callable, g: Callable):
    """GSPMD-sharded fused GSUKF step (bank axis data-parallel): the
    batched Cholesky/UKF math partitions elementwise over the bank; the
    weight reductions and the resampling gather become psum/all-gather."""
    from gpu_se_tpu.filters import gs_ukf
    from gpu_se_tpu.filters.gs_ukf import GSUKFState

    m_sh = NamedSharding(mesh, P(PARTICLE_AXIS, None))
    c_sh = NamedSharding(mesh, P(PARTICLE_AXIS, None, None))
    w_sh = NamedSharding(mesh, P(PARTICLE_AXIS))
    r_sh = NamedSharding(mesh, P())
    state_sh = GSUKFState(means=m_sh, covariances=c_sh, weights=w_sh, key=r_sh)

    @partial(
        jax.jit,
        in_shardings=(state_sh, r_sh, r_sh, r_sh, None, None),
        out_shardings=state_sh,
    )
    def step(state, u, z, dt, state_pdf, measurement_pdf):
        return gs_ukf.step(state, u, z, dt, f, g, state_pdf, measurement_pdf)

    return step


def make_shard_map_gsukf_step(mesh: Mesh, f: Callable, g: Callable,
                              axis: str = PARTICLE_AXIS,
                              resample_impl: str = "xla"):
    """Explicit shard_map GSUKF step: per-shard sigma-point predict/update
    (gs_ukf.predict_core/update_core) + distributed systematic resample of
    the (means, covariances) bank — the hand-scheduled analogue of the
    reference's GPU resample of both arrays
    (/root/reference/filter/gs_ukf.py:409-436). Sigma-point noise is drawn
    outside the shard_map with partitionable keys, so the result matches
    the single-device step under the identical key schedule.

    ``resample_impl``: "xla" (ring protocol), "a2a" (ragged all-to-all
    exchange) or "a2a_ring" (its ppermute emulation)."""
    from gpu_se_tpu.filters import gs_ukf
    from gpu_se_tpu.filters.gs_ukf import GSUKFState

    exchange = _exchange_for(resample_impl, {"a2a": "ragged",
                                             "a2a_ring": "ring"})

    def step(state: GSUKFState, u, z, dt, state_pdf: GaussianSum,
             measurement_pdf: GaussianSum) -> GSUKFState:
        n, nx = state.means.shape
        key, k_noise, k_r = jax.random.split(state.key, 3)
        noise = state_pdf.draw(k_noise, (n, 2 * nx + 1))
        r = jax.random.uniform(k_r, ())

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(
                P(axis, None), P(axis, None, None), P(axis),
                P(), P(), P(), P(axis, None, None), P(),
            ),
            out_specs=(P(axis, None), P(axis, None, None), P(axis)),
            check_vma=False,
        )
        def sharded(means, covs, weights, u, z, dt, noise, r):
            means, covs = gs_ukf.predict_core(means, covs, u, dt, noise, f)
            means, covs, weights = gs_ukf.update_core(
                means, covs, weights, u, z, g, measurement_pdf
            )
            if exchange is None:
                (means, covs), weights = _distributed_systematic_resample(
                    (means, covs), weights, r, axis
                )
            else:
                (means, covs), weights = _distributed_systematic_resample_a2a(
                    (means, covs), weights, r, axis, exchange=exchange
                )
            return means, covs, weights

        means, covs, weights = sharded(
            state.means, state.covariances, state.weights, u, z,
            jnp.asarray(dt, state.means.dtype), noise, r,
        )
        return GSUKFState(means=means, covariances=covs, weights=weights, key=key)

    m_sh = NamedSharding(mesh, P(axis, None))
    c_sh = NamedSharding(mesh, P(axis, None, None))
    w_sh = NamedSharding(mesh, P(axis))
    r_sh = NamedSharding(mesh, P())
    state_shardings = GSUKFState(means=m_sh, covariances=c_sh, weights=w_sh, key=r_sh)
    return jax.jit(
        step,
        in_shardings=(state_shardings, r_sh, r_sh, None, None, None),
        out_shardings=state_shardings,
    )
