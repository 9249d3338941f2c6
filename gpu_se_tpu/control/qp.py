"""Dense ADMM QP solver with OSQP semantics, built from dense matmuls.

Solves  min 1/2 x^T P x + q^T x  s.t.  l <= A x <= u.

The reference delegates this to the OSQP C library
(/root/reference/controller.py:231-267): sparse CSC matrices, a cached
LDL factorization, warm-started ``update(l, u)`` + ``solve`` per control
step. The re-design keeps the algorithm (ADMM with Ruiz
equilibration, per-row rho, relaxation, infeasibility certificates) but
changes the data layout and the linear solve:

* dense matrices — the MPC QP is condensed first (see ``mpc.py``), so
  n is the control-move count, not the full stacked horizon;
* the KKT solve ``(P + sigma I + A^T diag(rho) A)^{-1} rhs`` is a
  precomputed **dense inverse applied by matmul** plus one step of
  iterative refinement to recover float32 accuracy — no triangular
  solves, which serialize on an accelerator;
* the iteration loop is a ``lax.while_loop`` with residual/infeasibility
  checks every ``check_every`` iterations, so a solve is a single device
  dispatch and can be vmapped over scenario batches.

Setup (scaling, rho selection, inversion) runs once on host in float64;
only ``q``, ``l``, ``u`` and the warm-start state change per step.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from gpu_se_tpu import pytree

# Status codes (OSQP-compatible naming)
SOLVED = 1
MAX_ITER_REACHED = 0
PRIMAL_INFEASIBLE = -3
DUAL_INFEASIBLE = -4


@dataclasses.dataclass
class QPSettings:
    rho: float = 0.1
    rho_eq_scale: float = 1e3  # rho multiplier for equality rows (l == u)
    sigma: float = 1e-6
    alpha: float = 1.6
    eps_abs: float = 1e-4
    eps_rel: float = 1e-4
    eps_infeas: float = 1e-4
    max_iter: int = 4000
    check_every: int = 25
    scaling_iters: int = 10
    # adaptive rho (OSQP-style): scale rho by sqrt(prim_rel/dual_rel) when
    # the ratio drifts past the threshold, refactorizing K on device
    adaptive_rho: bool = True
    adaptive_rho_threshold: float = 5.0
    rho_min: float = 1e-6
    rho_max: float = 1e6
    # set automatically by DenseQP when P is (a multiple of) the identity:
    # the KKT solve uses the Woodbury identity through an m x m factor, so
    # no n x n matrix is ever built or shipped to the device
    identity_hessian: bool = False
    dtype: jnp.dtype = jnp.float32


@pytree.dataclass
class QPConstants:
    """Device-resident trace-time constants for a fixed (P, A) pair."""

    P_s: jax.Array  # scaled P (n, n); (0, 0) dummy in identity mode
    A_s: jax.Array  # scaled A (m, n)
    K: jax.Array  # P_s + sigma I + A_s^T diag(rho) A_s; (0, 0) in identity mode
    K_inv: jax.Array
    rho: jax.Array  # (m,)
    rho_inv: jax.Array
    d_scale: jax.Array  # (n,) Ruiz D diagonal
    e_scale: jax.Array  # (m,) Ruiz E diagonal
    c_scale: jax.Array  # scalar cost scaling
    aat: jax.Array  # (m, m) A_s A_s^T — identity mode only, else (0, 0)
    s_fac: jax.Array  # (m, m) inv(diag(1/rho) + aat / (1 + sigma)) — identity mode


@pytree.dataclass
class QPSolution:
    x: jax.Array
    y: jax.Array
    z: jax.Array
    status: jax.Array
    iterations: jax.Array
    prim_res: jax.Array
    dual_res: jax.Array


def _ruiz_equilibrate(P: np.ndarray, A: np.ndarray, q: np.ndarray, iters: int):
    """Modified Ruiz equilibration of the stacked KKT matrix + cost scaling
    (the dense analogue of OSQP's scaling routine)."""
    n = P.shape[0]
    m = A.shape[0]
    d = np.ones(n)
    e = np.ones(m) if m else np.ones(0)
    c = 1.0
    for _ in range(iters):
        P_s = c * (d[:, None] * P * d[None, :])
        A_s = (e[:, None] * A * d[None, :]) if m else A
        # column norms over the stacked [P_s; A_s]
        col_norm = np.maximum(
            np.abs(P_s).max(axis=0), np.abs(A_s).max(axis=0) if m else 0.0
        )
        col_norm = np.where(col_norm > 1e-12, col_norm, 1.0)
        delta_d = 1.0 / np.sqrt(col_norm)
        if m:
            row_norm = np.abs(A_s).max(axis=1)
            row_norm = np.where(row_norm > 1e-12, row_norm, 1.0)
            delta_e = 1.0 / np.sqrt(row_norm)
            e = e * delta_e
        d = d * delta_d
        # cost scaling: norms of the *currently scaled* cost data
        P_s = c * (d[:, None] * P * d[None, :])
        p_col_mean = np.abs(P_s).max(axis=0).mean()
        q_norm = np.abs(c * d * q).max() if q is not None else 0.0
        denom = max(p_col_mean, q_norm)
        gamma = 1.0 / denom if denom > 1e-12 else 1.0
        c = c * gamma
    return d, e, c


class DenseQP:
    """Host-side setup + jitted solve for a QP family with fixed (P, A).

    Parameters
    ----------
    P : (n, n) Hessian (PSD)
    A : (m, n) constraint matrix
    l_pattern, u_pattern : (m,) representative bounds used only to decide
        which rows are equalities for per-row rho (values may change per
        solve, the equality *pattern* must not — same contract as OSQP's
        ``update(l, u)``).
    q_pattern : (n,) representative linear cost for cost scaling.
    """

    def __init__(
        self,
        P: np.ndarray,
        A: np.ndarray,
        l_pattern: Optional[np.ndarray] = None,
        u_pattern: Optional[np.ndarray] = None,
        q_pattern: Optional[np.ndarray] = None,
        settings: Optional[QPSettings] = None,
    ):
        self.settings = settings or QPSettings()
        s = self.settings
        P = np.asarray(P, dtype=np.float64)
        A = np.atleast_2d(np.asarray(A, dtype=np.float64))
        if A.size == 0:
            A = np.zeros((0, P.shape[0]))
        self.n = P.shape[0]
        self.m = A.shape[0]
        q_pattern = (
            np.zeros(self.n) if q_pattern is None else np.asarray(q_pattern, float)
        )

        # identity-Hessian fast path: no n x n matrix is built or shipped;
        # the KKT solve goes through an m x m Woodbury factor
        is_identity = P[0, 0] > 0 and np.array_equal(P, P[0, 0] * np.eye(self.n))
        if is_identity:
            d = np.ones(self.n)
            c = 1.0 / P[0, 0]
            if self.m:
                row_norm = np.abs(A).max(axis=1)
                e = 1.0 / np.where(row_norm > 1e-12, row_norm, 1.0)
                A_s = e[:, None] * A
            else:
                e = np.ones(0)
                A_s = A
            P_s = np.zeros((0, 0))
            K = K_inv = np.zeros((0, 0))
        else:
            d, e, c = _ruiz_equilibrate(P, A, q_pattern, s.scaling_iters)
            P_s = c * (d[:, None] * P * d[None, :])
            A_s = e[:, None] * A * d[None, :] if self.m else A

        # per-row rho: equalities get rho * rho_eq_scale
        rho_vec = np.full(self.m, s.rho)
        if self.m and l_pattern is not None and u_pattern is not None:
            eq = np.isclose(np.asarray(l_pattern, float), np.asarray(u_pattern, float))
            rho_vec = np.where(eq, s.rho * s.rho_eq_scale, s.rho)

        beta = 1.0 + s.sigma
        if is_identity:
            aat = A_s @ A_s.T if self.m else np.zeros((0, 0))
            if self.m:
                s_fac = np.linalg.inv(np.diag(1.0 / rho_vec) + aat / beta)
            else:
                s_fac = np.zeros((0, 0))
        else:
            aat = s_fac = np.zeros((0, 0))
            K = P_s + s.sigma * np.eye(self.n)
            if self.m:
                K = K + A_s.T @ (rho_vec[:, None] * A_s)
            K_inv = np.linalg.inv(K)

        self.settings = s = dataclasses.replace(s, identity_hessian=is_identity)
        dt = s.dtype
        self.consts = QPConstants(
            P_s=jnp.asarray(P_s, dt),
            A_s=jnp.asarray(A_s, dt),
            K=jnp.asarray(K, dt),
            K_inv=jnp.asarray(K_inv, dt),
            rho=jnp.asarray(rho_vec, dt),
            rho_inv=jnp.asarray(1.0 / rho_vec if self.m else rho_vec, dt),
            d_scale=jnp.asarray(d, dt),
            e_scale=jnp.asarray(e, dt),
            c_scale=jnp.asarray(c, dt),
            aat=jnp.asarray(aat, dt),
            s_fac=jnp.asarray(s_fac, dt),
        )
        self._solve = jax.jit(partial(_admm_solve, settings=s))

    def solve_batch(self, qs, ls, us, x0s=None, y0s=None) -> QPSolution:
        """Solve a batch of QPs sharing (P, A) — vmapped ADMM, one
        device dispatch for the whole batch (the scenario-axis primitive:
        Monte-Carlo disturbance scenarios, control-period sweeps)."""
        dt = self.settings.dtype
        qs = jnp.asarray(qs, dt)
        b = qs.shape[0]
        ls = jnp.asarray(ls, dt)
        us = jnp.asarray(us, dt)
        if x0s is None:
            x0s = jnp.zeros((b, self.n), dt)
        if y0s is None:
            y0s = jnp.zeros((b, self.m), dt)
        if not hasattr(self, "_solve_vmapped"):
            self._solve_vmapped = jax.jit(
                jax.vmap(
                    partial(_admm_solve, settings=self.settings),
                    in_axes=(None, 0, 0, 0, 0, 0),
                )
            )
        return self._solve_vmapped(self.consts, qs, ls, us, x0s, y0s)

    def solve(
        self, q, l, u, x0=None, y0=None
    ) -> QPSolution:
        dt = self.settings.dtype
        q = jnp.asarray(q, dt)
        l = jnp.asarray(l, dt)
        u = jnp.asarray(u, dt)
        if x0 is None:
            x0 = jnp.zeros(self.n, dt)
        if y0 is None:
            y0 = jnp.zeros(self.m, dt)
        return self._solve(self.consts, q, l, u, jnp.asarray(x0, dt), jnp.asarray(y0, dt))


# ----------------------------------------------------------------------
def _admm_solve(
    c: QPConstants,
    q: jax.Array,
    l: jax.Array,
    u: jax.Array,
    x0: jax.Array,
    y0: jax.Array,
    settings: QPSettings,
) -> QPSolution:
    """Precision shim: pins float32 matmul passes around the real solve.

    A default-precision float32 matmul may run in TF32 on a GPU (a
    10-bit mantissa, about three decimal digits); the ADMM residuals must
    be computed in true float32 or the 1e-6 tolerances are unreachable.
    This is a trace-time context (a ``with`` so an exception
    mid-trace cannot leak it), pinning every matmul the solver emits with
    no effect on other code.
    """
    with jax.default_matmul_precision("float32"):
        return _admm_solve_impl(c, q, l, u, x0, y0, settings)


def _admm_solve_impl(
    c: QPConstants,
    q: jax.Array,
    l: jax.Array,
    u: jax.Array,
    x0: jax.Array,
    y0: jax.Array,
    settings: QPSettings,
) -> QPSolution:
    """One jitted ADMM solve. Inputs/outputs are in UNSCALED units.

    Implements OSQP's adaptive-rho scheme: when the primal/dual relative
    residual ratio drifts past ``adaptive_rho_threshold``, rho is scaled
    by sqrt(prim_rel / dual_rel) and the KKT matrix is refactorized — on
    device, as a dense ``jnp.linalg.inv`` (cheap because the MPC hands us
    a whitened, well-conditioned Hessian; cf. mpc.py). Without this, an
    active constraint whose multiplier is >> rho * violation stalls for
    tens of thousands of iterations (observed on the canonical rig).
    """
    s = settings
    m = c.A_s.shape[0]
    big = jnp.asarray(jnp.finfo(s.dtype).max / 4, s.dtype)

    # scale problem data
    q_s = c.c_scale * c.d_scale * q
    l_s = jnp.clip(c.e_scale * l, -big, big)
    u_s = jnp.clip(c.e_scale * u, -big, big)

    # warm start in scaled coordinates
    x = x0 / c.d_scale
    y = (c.c_scale / c.e_scale) * y0 if m else y0
    z = c.A_s @ x if m else jnp.zeros((0,), s.dtype)
    z = jnp.clip(z, l_s, u_s)

    ident = s.identity_hessian
    beta = 1.0 + s.sigma

    def kkt_solve(K, K_inv, s_fac, rhs):
        if ident:
            # Woodbury: (beta I + A' R A)^{-1} = I/beta - A' S^{-1} A / beta^2
            if m:
                return rhs / beta - (c.A_s.T @ (s_fac @ (c.A_s @ rhs))) / (beta * beta)
            return rhs / beta
        sol = K_inv @ rhs
        r = rhs - K @ sol
        return sol + K_inv @ r  # one refinement step for f32 accuracy

    def residuals(x, z, y):
        ax = c.A_s @ x
        prim = (
            jnp.max(jnp.abs((ax - z) / c.e_scale)) if m else jnp.asarray(0.0, s.dtype)
        )
        px = x / c.c_scale if ident else c.P_s @ x
        aty = c.A_s.T @ y if m else jnp.zeros_like(x)
        dual = jnp.max(jnp.abs((px + q_s + aty) / c.d_scale)) / c.c_scale
        # relative denominators (unscaled norms)
        denom_p = jnp.maximum(
            jnp.max(jnp.abs(ax / c.e_scale)) if m else jnp.asarray(0.0, s.dtype),
            jnp.max(jnp.abs(z / c.e_scale)) if m else jnp.asarray(0.0, s.dtype),
        )
        denom_d = jnp.max(
            jnp.stack(
                [
                    jnp.max(jnp.abs(px / c.d_scale)),
                    jnp.max(jnp.abs(aty / c.d_scale)),
                    jnp.max(jnp.abs(q_s / c.d_scale)),
                ]
            )
        ) / c.c_scale
        return prim, dual, denom_p, denom_d

    def check_infeasibility(dx, dy):
        eps = s.eps_infeas
        # primal infeasibility certificate from dy (unscaled: E dy / c)
        dy_un = c.e_scale * dy / c.c_scale if m else dy
        norm_dy = jnp.max(jnp.abs(dy_un)) if m else jnp.asarray(0.0, s.dtype)
        aty_dy = (
            jnp.max(jnp.abs((c.A_s.T @ dy) / c.d_scale / c.c_scale))
            if m
            else jnp.asarray(jnp.inf, s.dtype)
        )
        dy_plus = jnp.maximum(dy_un, 0.0)
        dy_minus = jnp.minimum(dy_un, 0.0)
        sup = jnp.sum(jnp.where(dy_plus > 0, u * dy_plus, 0.0)) + jnp.sum(
            jnp.where(dy_minus < 0, l * dy_minus, 0.0)
        ) if m else jnp.asarray(jnp.inf, s.dtype)
        prim_infeas = (
            (norm_dy > 1e-12)
            & (aty_dy <= eps * norm_dy)
            & (sup <= -eps * norm_dy)
        )
        # dual infeasibility certificate from dx
        dx_un = c.d_scale * dx
        norm_dx = jnp.max(jnp.abs(dx_un))
        pdx_vec = dx / c.c_scale if ident else c.P_s @ dx
        pdx = jnp.max(jnp.abs(pdx_vec / c.d_scale)) / c.c_scale
        qdx = jnp.dot(q_s / c.d_scale, dx_un) / c.c_scale
        if m:
            adx = (c.A_s @ dx) / c.e_scale
            up_ok = jnp.all(
                jnp.where(jnp.isfinite(u), adx <= eps * norm_dx, True)
            )
            lo_ok = jnp.all(
                jnp.where(jnp.isfinite(l), adx >= -eps * norm_dx, True)
            )
        else:
            up_ok = lo_ok = jnp.asarray(True)
        dual_infeas = (
            (norm_dx > 1e-12)
            & (pdx <= eps * norm_dx)
            & (qdx <= -eps * norm_dx)
            & up_ok
            & lo_ok
        )
        return prim_infeas, dual_infeas

    def refactor(rho):
        if ident:
            s_fac = jnp.linalg.inv(jnp.diag(1.0 / rho) + c.aat / beta)
            return c.K, c.K_inv, s_fac
        K = c.P_s + s.sigma * jnp.eye(c.P_s.shape[0], dtype=s.dtype)
        if m:
            K = K + c.A_s.T @ (rho[:, None] * c.A_s)
        return K, jnp.linalg.inv(K), c.s_fac

    def body(carry):
        x, z, y, x_prev, y_prev, it, status, prim, dual, rho, K, K_inv, s_fac = carry
        rho_inv = 1.0 / rho if m else rho
        # x-update
        rhs = s.sigma * x - q_s + (c.A_s.T @ (rho * z - y) if m else 0.0)
        x_t = kkt_solve(K, K_inv, s_fac, rhs)
        x_new = s.alpha * x_t + (1 - s.alpha) * x
        if m:
            z_t = c.A_s @ x_t
            # z_pre carries rho^{-1} y, so the dual update collapses to
            # y_new = rho (z_pre - z_new)  [OSQP Algorithm 1 steps 4-5]
            z_pre = s.alpha * z_t + (1 - s.alpha) * z + rho_inv * y
            z_new = jnp.clip(z_pre, l_s, u_s)
            y_new = rho * (z_pre - z_new)
        else:
            z_new, y_new = z, y

        it_new = it + 1

        def do_check(_):
            prim_r, dual_r, denom_p, denom_d = residuals(x_new, z_new, y_new)
            eps_p = s.eps_abs + s.eps_rel * denom_p
            eps_d = s.eps_abs + s.eps_rel * denom_d
            solved = (prim_r <= eps_p) & (dual_r <= eps_d)
            p_inf, d_inf = check_infeasibility(x_new - x_prev, y_new - y_prev)
            new_status = jnp.where(
                solved,
                SOLVED,
                jnp.where(
                    p_inf, PRIMAL_INFEASIBLE, jnp.where(d_inf, DUAL_INFEASIBLE, status)
                ),
            ).astype(jnp.int32)

            if m and s.adaptive_rho:
                tiny = jnp.asarray(1e-10, s.dtype)
                prim_rel = prim_r / (denom_p + tiny)
                dual_rel = dual_r / (denom_d + tiny)
                factor = jnp.sqrt(prim_rel / (dual_rel + tiny) + tiny)
                need = (new_status == MAX_ITER_REACHED) & (
                    (factor > s.adaptive_rho_threshold)
                    | (factor < 1.0 / s.adaptive_rho_threshold)
                )

                def adapt(_):
                    new_rho = jnp.clip(rho * factor, s.rho_min, s.rho_max)
                    K2, K_inv2, s_fac2 = refactor(new_rho)
                    return new_rho, K2, K_inv2, s_fac2

                rho2, K2, K_inv2, s_fac2 = jax.lax.cond(
                    need, adapt, lambda _: (rho, K, K_inv, s_fac), None
                )
            else:
                rho2, K2, K_inv2, s_fac2 = rho, K, K_inv, s_fac
            return new_status, prim_r, dual_r, rho2, K2, K_inv2, s_fac2

        def no_check(_):
            return status, prim, dual, rho, K, K_inv, s_fac

        status_new, prim_new, dual_new, rho_new, K_new, K_inv_new, s_fac_new = jax.lax.cond(
            it_new % s.check_every == 0, do_check, no_check, None
        )
        return (
            x_new, z_new, y_new, x, y, it_new,
            status_new, prim_new, dual_new, rho_new, K_new, K_inv_new, s_fac_new,
        )

    def cond(carry):
        it, status = carry[5], carry[6]
        return (it < s.max_iter) & (status == MAX_ITER_REACHED)

    init = (
        x,
        z,
        y,
        x,
        y,
        jnp.asarray(0, jnp.int32),
        jnp.asarray(MAX_ITER_REACHED, jnp.int32),
        jnp.asarray(jnp.inf, s.dtype),
        jnp.asarray(jnp.inf, s.dtype),
        c.rho,
        c.K,
        c.K_inv,
        c.s_fac,
    )
    out = jax.lax.while_loop(cond, body, init)
    x, z, y, it, status = out[0], out[1], out[2], out[5], out[6]

    # final residual check in case max_iter landed between checks
    prim_r, dual_r, denom_p, denom_d = residuals(x, z, y)
    status = jnp.where(
        (status == MAX_ITER_REACHED)
        & (prim_r <= s.eps_abs + s.eps_rel * denom_p)
        & (dual_r <= s.eps_abs + s.eps_rel * denom_d),
        SOLVED,
        status,
    )

    return QPSolution(
        x=c.d_scale * x,
        y=(c.e_scale * y / c.c_scale) if m else y,
        z=(z / c.e_scale) if m else z,
        status=status,
        iterations=it,
        prim_res=prim_r,
        dual_res=dual_r,
    )
