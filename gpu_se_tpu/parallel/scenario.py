"""Scenario-axis parallelism for the MPC (BASELINE.json north star).

Two primitives over a batch of disturbance scenarios (x0, u_-1, bias):

* :func:`make_scenario_solver` — vmapped *independent* per-scenario QP
  solves, optionally ``shard_map``-ped over the mesh so each device solves
  its shard of scenarios (Monte-Carlo evaluation, control-period sweeps).

* :func:`make_consensus_scenario_step` — TRUE stochastic MPC: one shared
  first move du_0 over all scenarios, per-scenario recourse and
  constraints, solved by consensus ADMM. Each outer iteration every
  shard solves its scenarios' proximal QPs with the vmapped dense ADMM
  (identity-Hessian Woodbury path, see scenario_mpc.consensus_consts),
  then the consensus du_0 is ONE ``psum`` across devices. Converges to the
  stacked scenario optimum (oracle: control/scenario_mpc.ScenarioMPC;
  pinned in tests/test_scenario_mpc.py) — unlike solving at the scenario
  mean, which certainty-equivalence makes optimal only while no
  per-scenario constraint binds.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from gpu_se_tpu.control import mpc as mpc_mod
from gpu_se_tpu.control.qp import _admm_solve
from gpu_se_tpu.parallel.mesh import PARTICLE_AXIS


def make_scenario_solver(mpc, mesh=None, axis: str = PARTICLE_AXIS):
    """Return ``solve(x0s, um1s, biases) -> (ctrls, y_preds, statuses)``
    solving one INDEPENDENT QP per scenario row, sharded over ``mesh``
    if given."""
    consts, step_fn = mpc_mod.make_device_step(mpc)
    n_d = (mpc.M + 1) * mpc.Ni
    m_rows = mpc.qp.m

    def one(x0, um1, bias):
        warm_v = jnp.zeros(n_d, jnp.float32)
        warm_y = jnp.zeros(m_rows, jnp.float32)
        ctrl, y_pred, sol = step_fn(consts, x0, um1, bias, warm_v, warm_y)
        return ctrl, y_pred, sol.status

    batched = jax.vmap(one)

    if mesh is None:
        return jax.jit(batched)

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None)),
        out_specs=(P(axis, None), P(axis, None), P(axis)),
        check_vma=False,
    )
    def sharded(x0s, um1s, biases):
        return batched(x0s, um1s, biases)

    return jax.jit(sharded)


def _consensus_local(consts, x0s, um1, biases, *, settings, dims, n_outer,
                     reduce_sum, reduce_min, n_total):
    """Consensus-ADMM body over this shard's scenarios.

    ``reduce_sum``/``reduce_min`` are ``psum``/``pmin`` inside shard_map,
    identity when unsharded; ``n_total`` the global scenario count.
    """
    # A default-precision float32 matmul may run in TF32 on a GPU (about
    # three decimal digits); the whitened linear terms and the du_0
    # extraction must be true float32 or the consensus gap stalls far
    # above its tolerance. Trace-time context, same as qp._admm_solve.
    with jax.default_matmul_precision("float32"):
        return _consensus_local_body(
            consts, x0s, um1, biases, settings=settings, dims=dims,
            n_outer=n_outer, reduce_sum=reduce_sum, reduce_min=reduce_min,
            n_total=n_total,
        )


def _consensus_local_body(consts, x0s, um1, biases, *, settings, dims,
                          n_outer, reduce_sum, reduce_min, n_total):
    c = consts
    ni, n_d, m = dims["ni"], dims["n_d"], dims["m"]
    s_loc = x0s.shape[0]
    dt = x0s.dtype

    # per-scenario condensed data (fixed across outer iterations)
    bias_terms = jnp.einsum("k,so->sko", c["k_vec"], biases).reshape(s_loc, -1)
    y_free = x0s @ c["F_x"].T + (c["F_u"] @ um1)[None, :] + bias_terms
    q_s = (y_free - c["ysp_tile"][None, :]) @ c["theta_t_q"].T  # (s_loc, n_d)

    l_parts, u_parts = [], []
    if dims["has_y"]:
        l_parts.append(c["y_lo"][None, :] - y_free)
        u_parts.append(c["y_hi"][None, :] - y_free)
    if dims["has_du"]:
        l_parts.append(jnp.broadcast_to(c["du_lo"], (s_loc, n_d)))
        u_parts.append(jnp.broadcast_to(c["du_hi"], (s_loc, n_d)))
    if dims["has_u0"]:
        l_parts.append(jnp.broadcast_to(c["u_lo"] - um1, (s_loc, ni)))
        u_parts.append(jnp.broadcast_to(c["u_hi"] - um1, (s_loc, ni)))
    if l_parts:
        l = jnp.concatenate(l_parts, axis=1)
        u = jnp.concatenate(u_parts, axis=1)
    else:
        l = jnp.zeros((s_loc, 0), dt)
        u = jnp.zeros((s_loc, 0), dt)

    solve = jax.vmap(
        partial(_admm_solve, settings=settings),
        in_axes=(None, 0, 0, 0, 0, 0),
    )
    ctrl_rows = c["L_invT"][:ni]  # d0 = ctrl_rows @ w

    def outer(carry, _):
        zbar, lam, warm_w, warm_y = carry
        v = zbar[None, :] - lam  # (s_loc, ni) proximal targets
        q_eff = q_s.at[:, :ni].add(-c["rho_c"] * v)
        q_w = q_eff @ c["L_inv"].T
        sols = solve(c["qp"], q_w, l, u, warm_w, warm_y)
        d0 = sols.x @ ctrl_rows.T  # (s_loc, ni)
        zbar_new = reduce_sum(jnp.sum(d0 + lam, axis=0)) / n_total
        lam_new = lam + d0 - zbar_new[None, :]
        gap = reduce_sum(jnp.max(jnp.abs(d0 - zbar_new[None, :]), axis=1).sum())
        # worst status must be reduced ACROSS shards too — a shard-local
        # min through replicated out_specs would report shard 0's value
        worst = reduce_min(jnp.min(sols.status))
        return (zbar_new, lam_new, sols.x, sols.y), (gap, worst)

    init = (
        jnp.zeros(ni, dt),
        jnp.zeros((s_loc, ni), dt),
        jnp.zeros((s_loc, n_d), dt),
        jnp.zeros((s_loc, m), dt),
    )
    (zbar, _, _, _), (gaps, worsts) = jax.lax.scan(
        outer, init, None, length=n_outer
    )
    return zbar + um1, gaps[-1], worsts[-1]


def make_consensus_scenario_step(settings, dims, mesh=None,
                                 axis: str = PARTICLE_AXIS, n_outer: int = 40):
    """Build the consensus scenario-MPC step.

    Parameters
    ----------
    settings, dims : from
        :func:`gpu_se_tpu.control.scenario_mpc.consensus_consts`.
    mesh : optional 1-D mesh to shard the scenario axis over.
    n_outer : consensus (outer ADMM) iterations.

    Returns ``step(consts, x0s, um1, biases) -> (ctrl, gap, worst_status)``
    — the ``consts`` dict from ``consensus_consts`` is a per-call jit
    argument (never baked into the HLO). ``gap`` is the final consensus
    residual ``sum_s max|du_0^s - mean|``; ``worst_status`` the minimum
    inner QP status over ALL scenarios and shards (SOLVED=1).
    """
    if mesh is None:
        def step(consts, x0s, um1, biases):
            n_total = x0s.shape[0]
            return _consensus_local(
                consts, x0s, um1, biases, settings=settings, dims=dims,
                n_outer=n_outer, reduce_sum=lambda x: x,
                reduce_min=lambda x: x, n_total=n_total,
            )
        return jax.jit(step)

    def step(consts, x0s, um1, biases):
        n_total = x0s.shape[0]

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P(axis, None), P(), P(axis, None)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
        def sharded(consts, x0s, um1, biases):
            return _consensus_local(
                consts, x0s, um1, biases, settings=settings, dims=dims,
                n_outer=n_outer,
                reduce_sum=lambda x: jax.lax.psum(x, axis),
                reduce_min=lambda x: jax.lax.pmin(x, axis),
                n_total=n_total,
            )

        return sharded(consts, x0s, um1, biases)

    return jax.jit(step)
