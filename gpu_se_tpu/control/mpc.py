"""Linear MPC on a condensed, whitened, optimum-centered dense QP.

The reference builds the MPC as a sparse *simultaneous-form* QP over the
stacked vector [states; outputs; u_-1; input moves] with equality rows
encoding the velocity-form recursions, and hands it to OSQP in float64
(/root/reference/controller.py:63-238). This redesign applies
three exact transformations at setup so the per-step solve is small,
dense, and float32-stable:

1. **Condensation** — the equality recursions are eliminated analytically
   into dense prediction maps over the control moves d = [du_0 .. du_M];
   the decision vector shrinks from (P+1)Nx + P*No + (M+2)Ni to (M+1)Ni.
2. **Whitening** — substituting w = L^T d (L = chol of the condensed
   Hessian) makes the Hessian exactly identity; the raw Hessian's
   condition number (~1e8 on the canonical rig: squared step-response
   gain) never reaches the device.
3. **Optimum centering** — substituting w = -q + v makes the objective
   (1/2)||v||^2: a least-norm projection onto the constraint polyhedron.
   The linear cost q (which reaches ~1e5 once output-bias integral action
   accumulates) is never materialized; its effect on the bounds and on
   the recovered controls enters through small matrices precomposed in
   float64 at setup (A_w W F_x etc.), evaluated per step on host in
   float64 (a few-hundred-flop matvec) — so the float32 device solve only
   ever sees O(1)-conditioned data and the small vector v.

Semantics preserved from the reference (verified in tests):

* velocity form with output-bias integral action: y_k carries k*bias
  (bias = y0 - y_predicted, cf. /root/reference/controller.py:256-262);
* the input-magnitude constraint applies to u_0 = u_-1 + du_0 ONLY — the
  reference builds the full lower-triangular constraint then overwrites
  it with the reduced form (/root/reference/controller.py:200-220);
* du_M never enters the state recursion, only the D feed-through
  (/root/reference/controller.py:135-146);
* ctrl = du_0 + u_-1; y_predicted = y_1 - bias
  (/root/reference/controller.py:274-277);
* solver-failure contract: ``step`` raises ValueError on a non-solved
  status for the caller-side fallback (/root/reference/controller.py:270-271).

Rows whose bounds are infinite on both sides are pruned at setup (the
canonical rig has no output or step bounds, so its per-step QP carries
only the Ni input rows).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

from gpu_se_tpu.control.qp import SOLVED, DenseQP, QPSettings, _admm_solve
from gpu_se_tpu.models.linear import LinearModel


def build_prediction_matrices(lin: LinearModel, P: int, M: int):
    """Condense the velocity-form recursions into dense prediction maps.

    Returns
    -------
    F_x : (P*No, Nx)   y_free state part: row block k is C A^k
    F_u : (P*No, Ni)   u_-1 part: C G_k B + D
    Theta : (P*No, (M+1)*Ni)  control-move map (see module docstring)
    k_vec : (P,)       bias multipliers (y_k carries k * bias)
    """
    A, B, C, D = lin.A, lin.B, lin.C, lin.D
    nx, ni, no = lin.Nx, lin.Ni, lin.No

    a_pows = np.empty((P + 1, nx, nx))
    a_pows[0] = np.eye(nx)
    for k in range(1, P + 1):
        a_pows[k] = a_pows[k - 1] @ A
    g = np.cumsum(a_pows[:P], axis=0)  # g[k-1] = G_k = I + A + ... + A^{k-1}

    F_x = np.einsum("oy,kyx->kox", C, a_pows[1:]).reshape(P * no, nx)

    t = np.einsum("oy,kyx,xi->koi", C, g, B)  # t[k-1] = C G_k B
    F_u = (t + D[None]).reshape(P * no, ni)

    # Theta[k, i] for k = 1..P (row), i = 0..M (col block):
    #   i = 0:       C G_k B + D
    #   1 <= i < M:  C G_{k-i} B * [k > i]  +  D * [k >= i]
    #   i = M:       D * [k >= M]
    ks = np.arange(1, P + 1)[:, None]
    is_ = np.arange(0, M + 1)[None, :]
    lag = ks - is_
    state_mask = (lag >= 1) & (is_ < M)
    t_full = np.concatenate([np.zeros((1, no, ni)), t])
    theta = t_full[np.clip(lag, 0, P)] * state_mask[..., None, None]
    d_mask = ks >= np.maximum(is_, 1)
    theta = theta + D[None, None] * d_mask[..., None, None]
    theta = theta.transpose(0, 2, 1, 3).reshape(P * no, (M + 1) * ni)

    k_vec = np.arange(1, P + 1, dtype=float)
    return F_x, F_u, theta, k_vec


def _mpc_solve_v(consts, l, u, warm_v, warm_y, *, settings):
    """Jitted core: least-norm ADMM in v-space with dynamic bounds."""
    n = consts["qp"].d_scale.shape[0]
    q0 = jnp.zeros(n, l.dtype)
    return _admm_solve(consts["qp"], q0, l, u, warm_v, warm_y, settings=settings)


class MPC:
    """Linear MPC with the reference constructor surface
    (/root/reference/controller.py:63-64)."""

    def __init__(
        self,
        P,
        M,
        Q,
        R,
        lin_model: LinearModel,
        ysp,
        y_bounds=None,
        u_bounds=None,
        u_step_bounds=None,
        qp_settings: Optional[QPSettings] = None,
    ):
        self.P, self.M = int(P), int(M)
        self.Q = np.atleast_2d(np.asarray(Q, float))
        self.R = np.atleast_2d(np.asarray(R, float))
        self.model = lin_model
        self.ysp = np.asarray(ysp, float)

        nx, ni, no = lin_model.Nx, lin_model.Ni, lin_model.No
        self.Nx, self.Ni, self.No = nx, ni, no
        n_d = (self.M + 1) * ni

        def unpack(bounds, dim):
            if bounds is None:
                return np.full(dim, -np.inf), np.full(dim, np.inf)
            lo, hi = [np.asarray(b, float) for b in zip(*bounds)]
            return lo, hi

        y_min, y_max = unpack(y_bounds, no)
        u_min, u_max = unpack(u_bounds, ni)
        du_min, du_max = unpack(u_step_bounds, ni)

        F_x, F_u, theta, k_vec = build_prediction_matrices(lin_model, self.P, self.M)

        # cost: (1/2) d' (Th' Qbar Th + Rbar) d + (y_free - ysp)' Qbar Th d
        # with Qbar = I_P (x) Q applied blockwise (Q symmetric).
        theta_r = theta.reshape(self.P, no, n_d)
        theta_t_q = (
            np.einsum("oy,kyn->kon", self.Q, theta_r).reshape(self.P * no, n_d).T
        )  # (n_d, P*No) = Th' Qbar
        r_blocks = np.kron(np.eye(self.M + 1), self.R)
        P_qp = theta_t_q @ theta + r_blocks

        # ---- whitening: w = L^T d, Hessian -> I ----
        ridge = 1e-12 * max(np.trace(P_qp) / n_d, 1.0)
        try:
            L = np.linalg.cholesky(P_qp)
        except np.linalg.LinAlgError:
            L = np.linalg.cholesky(P_qp + ridge * np.eye(n_d))
        L_invT = scipy.linalg.solve_triangular(L, np.eye(n_d), lower=True).T
        W = L_invT.T @ theta_t_q  # (n_d, P*No): q = W (y_free - ysp_tile)

        # constraint rows in w coordinates; prune all-infinite blocks
        self._has_y_rows = np.isfinite(y_min).any() or np.isfinite(y_max).any()
        self._has_du_rows = np.isfinite(du_min).any() or np.isfinite(du_max).any()
        self._has_u0_rows = np.isfinite(u_min).any() or np.isfinite(u_max).any()

        a_rows = []
        if self._has_y_rows:
            a_rows.append(theta @ L_invT)
        if self._has_du_rows:
            a_rows.append(L_invT)
        if self._has_u0_rows:
            a_rows.append(L_invT[:ni])
        A_qp = np.vstack(a_rows) if a_rows else np.zeros((0, n_d))
        m = A_qp.shape[0]

        l_rep = np.concatenate(
            ([np.tile(y_min, self.P)] if self._has_y_rows else [])
            + ([np.tile(du_min, self.M + 1)] if self._has_du_rows else [])
            + ([u_min] if self._has_u0_rows else [])
        ) if a_rows else np.zeros(0)
        u_rep = np.concatenate(
            ([np.tile(y_max, self.P)] if self._has_y_rows else [])
            + ([np.tile(du_max, self.M + 1)] if self._has_du_rows else [])
            + ([u_max] if self._has_u0_rows else [])
        ) if a_rows else np.zeros(0)

        if qp_settings is None:
            qp_settings = QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=10000)
        self.qp = DenseQP(
            np.eye(n_d), A_qp, l_rep, u_rep, np.zeros(n_d), settings=qp_settings
        )

        # ---- optimum centering: w = -q + v ------------------------------
        # Precompose (float64) every map through q so the large vector q
        # never materializes. For any matrix S (rows x n_d):
        #   S q = SQ_x x0 + SQ_u um1 + SQ_b bias - sq_0
        # with SQ_x = S W F_x, SQ_u = S W F_u, SQ_b = S W_b, sq_0 = S W ysp.
        W_b = (
            W.reshape(n_d, self.P, no) * k_vec[None, :, None]
        ).sum(axis=1)  # (n_d, No): W @ kron(k_vec, .)
        ysp_tile = np.tile(self.ysp, self.P)

        def compose(S):
            SW = S @ W
            return (
                SW @ F_x,
                SW @ F_u,
                S @ W_b,
                SW @ ysp_tile,
            )

        ctrl_map = L_invT[:ni]  # du_0 = ctrl_map @ w
        theta0_w = theta[:no] @ L_invT  # y_1 move part
        self._h = dict(
            A_q=compose(A_qp) if m else None,
            ctrl_q=compose(ctrl_map),
            y1_q=compose(theta0_w),
            F_x0=F_x[:no],
            F_u0=F_u[:no],
            F_x=F_x,
            F_u=F_u,
            k_vec=k_vec,
            ysp_tile=ysp_tile,
            y_lo=np.tile(y_min, self.P),
            y_hi=np.tile(y_max, self.P),
            du_lo=np.tile(du_min, self.M + 1),
            du_hi=np.tile(du_max, self.M + 1),
            u_lo=u_min,
            u_hi=u_max,
        )

        dt = self.qp.settings.dtype
        # Device constants passed as jit ARGUMENTS (never closed over —
        # closures would bake 100+ MB of constants into the HLO).
        self._consts = dict(
            qp=self.qp.consts,
            ctrl_map=jnp.asarray(ctrl_map, dt),
            theta0_w=jnp.asarray(theta0_w, dt),
        )
        self._solve_fn = jax.jit(partial(_mpc_solve_v, settings=self.qp.settings))
        self._extract_fn = jax.jit(_extract)

        self.y_predicted = None
        # True when the last step's QP stopped at max_iter and was accepted
        # as near-solved (see ``step``)
        self.near_solved = False
        self._warm_v = jnp.zeros(n_d, dt)
        self._warm_y = jnp.zeros(m, dt)

    # ------------------------------------------------------------------
    def _host_prepare(self, x0, um1, bias):
        """Float64 host preprocessing: bound shifts and unconstrained
        offsets (tiny matvecs — microseconds)."""
        h = self._h

        def through_q(parts):
            qx, qu, qb, q0 = parts
            return qx @ x0 + qu @ um1 + qb @ bias - q0

        l_parts, u_parts = [], []
        if self._has_y_rows:
            y_free = h["F_x"] @ x0 + h["F_u"] @ um1 + np.kron(h["k_vec"], bias)
            l_parts.append(h["y_lo"] - y_free)
            u_parts.append(h["y_hi"] - y_free)
        if self._has_du_rows:
            l_parts.append(h["du_lo"])
            u_parts.append(h["du_hi"])
        if self._has_u0_rows:
            l_parts.append(h["u_lo"] - um1)
            u_parts.append(h["u_hi"] - um1)

        if l_parts:
            aq = through_q(h["A_q"])
            l = np.concatenate(l_parts) + aq
            u = np.concatenate(u_parts) + aq
        else:
            l = np.zeros(0)
            u = np.zeros(0)

        ctrl_unc = -through_q(h["ctrl_q"]) + um1  # du_0(-q) + um1
        y1_unc = h["F_x0"] @ x0 + h["F_u0"] @ um1 + bias - through_q(h["y1_q"])
        return l, u, ctrl_unc, y1_unc

    # ------------------------------------------------------------------
    def step(self, x0, um1, y0):
        """Return the MPC control move; raises ValueError if the solver
        fails (caller-side fallback contract,
        /root/reference/controller.py:240-279)."""
        clip = lambda v: np.clip(np.asarray(v, float), -1e10, 1e10)
        x0, um1, y0 = clip(x0), clip(um1), clip(y0)

        if self.y_predicted is not None:
            bias = y0 - self.y_predicted
        else:
            bias = np.zeros_like(y0)

        l, u, ctrl_unc, y1_unc = self._host_prepare(x0, um1, bias)
        dt = self.qp.settings.dtype
        sol = self._solve_fn(
            self._consts, jnp.asarray(l, dt), jnp.asarray(u, dt),
            self._warm_v, self._warm_y,
        )
        ctrl, y1_move = self._extract_fn(self._consts, sol.x)

        status = int(sol.status)
        self.last_solution = sol
        if status != SOLVED:
            # OSQP-style "solved inaccurate" acceptance: the canonical
            # rig tightens the tolerances to 1e-6, but the float32 dual
            # residual can floor near 3e-5 on the P=300 problem while
            # the primal residual is ~1e-9 (fully feasible). Accept a
            # max-iter termination whose residuals meet the CLASS
            # DEFAULT tolerance (1e-4 — itself 10x stricter than the
            # reference's OSQP defaults, /root/reference/controller.py)
            # instead of failing the control step; ``near_solved``
            # records that it happened.
            from gpu_se_tpu.control.qp import QPSettings

            eps = max(10.0 * self.qp.settings.eps_abs,
                      QPSettings.eps_abs)
            near = (
                status == 0
                and float(sol.prim_res) < eps
                and float(sol.dual_res) < eps
            )
            if not near:
                raise ValueError(
                    f"QP solver did not solve the problem! Status: {status}")
        self.near_solved = status != SOLVED

        self._warm_v, self._warm_y = sol.x, sol.y
        ctrl_full = ctrl_unc + np.asarray(ctrl, float)
        self.y_predicted = y1_unc + np.asarray(y1_move, float) - bias
        return ctrl_full


def _extract(consts, v):
    """Device-side extraction of the v-dependent control/prediction parts,
    in full float32 (a default-precision GPU matmul may run in TF32)."""
    hi = jax.lax.Precision.HIGHEST
    return (jnp.matmul(consts["ctrl_map"], v, precision=hi),
            jnp.matmul(consts["theta0_w"], v, precision=hi))


# ----------------------------------------------------------------------
# Fully on-device step (for lax.scan closed loops and multi-chip dryruns).
# Float32 end to end: adequate for realistic closed-loop magnitudes; the
# host shell's float64 preprocessing path (MPC.step) is the robust default.
# ----------------------------------------------------------------------
def make_device_step(mpc: "MPC"):
    """Return ``(consts, step_fn)`` where ``step_fn(consts, x0, um1, bias,
    warm_v, warm_y) -> (ctrl, y_pred, sol)`` runs entirely on device."""
    h = mpc._h
    dt = mpc.qp.settings.dtype

    def dev(x):
        return jnp.asarray(np.asarray(x), dt)

    consts = dict(
        qp=mpc.qp.consts,
        ctrl_map=mpc._consts["ctrl_map"],
        theta0_w=mpc._consts["theta0_w"],
        A_q=tuple(dev(p) for p in h["A_q"]) if h["A_q"] is not None else None,
        ctrl_q=tuple(dev(p) for p in h["ctrl_q"]),
        y1_q=tuple(dev(p) for p in h["y1_q"]),
        F_x0=dev(h["F_x0"]),
        F_u0=dev(h["F_u0"]),
        F_x=dev(h["F_x"]) if mpc._has_y_rows else None,
        F_u=dev(h["F_u"]) if mpc._has_y_rows else None,
        k_vec=dev(h["k_vec"]) if mpc._has_y_rows else None,
        y_lo=dev(h["y_lo"]) if mpc._has_y_rows else None,
        y_hi=dev(h["y_hi"]) if mpc._has_y_rows else None,
        du_lo=dev(h["du_lo"]) if mpc._has_du_rows else None,
        du_hi=dev(h["du_hi"]) if mpc._has_du_rows else None,
        u_lo=dev(h["u_lo"]) if mpc._has_u0_rows else None,
        u_hi=dev(h["u_hi"]) if mpc._has_u0_rows else None,
    )
    has_y, has_du, has_u0 = mpc._has_y_rows, mpc._has_du_rows, mpc._has_u0_rows
    settings = mpc.qp.settings

    def step_fn(c, x0, um1, bias, warm_v, warm_y):
        # every product here in full float32, like the solve itself
        # (qp._admm_solve): a default-precision GPU matmul may run in TF32
        with jax.default_matmul_precision("float32"):
            return _device_step(c, x0, um1, bias, warm_v, warm_y)

    def _device_step(c, x0, um1, bias, warm_v, warm_y):
        def through_q(parts):
            qx, qu, qb, q0 = parts
            return qx @ x0 + qu @ um1 + qb @ bias - q0

        l_parts, u_parts = [], []
        if has_y:
            y_free = c["F_x"] @ x0 + c["F_u"] @ um1 + jnp.kron(c["k_vec"], bias)
            l_parts.append(c["y_lo"] - y_free)
            u_parts.append(c["y_hi"] - y_free)
        if has_du:
            l_parts.append(c["du_lo"])
            u_parts.append(c["du_hi"])
        if has_u0:
            l_parts.append(c["u_lo"] - um1)
            u_parts.append(c["u_hi"] - um1)
        if l_parts:
            aq = through_q(c["A_q"])
            l = jnp.concatenate(l_parts) + aq
            u = jnp.concatenate(u_parts) + aq
        else:
            l = jnp.zeros(0, x0.dtype)
            u = jnp.zeros(0, x0.dtype)

        sol = _admm_solve(c["qp"], jnp.zeros_like(warm_v), l, u, warm_v, warm_y,
                          settings=settings)
        ctrl = -through_q(c["ctrl_q"]) + um1 + c["ctrl_map"] @ sol.x
        y1 = c["F_x0"] @ x0 + c["F_u0"] @ um1 + bias - through_q(c["y1_q"]) + (
            c["theta0_w"] @ sol.x
        )
        return ctrl, y1 - bias, sol

    return consts, step_fn
