"""Independent float64 reference for the MPC: the reference's own QP layout.

:class:`ReferenceLayoutMPC` rebuilds the sparse simultaneous-form QP of
/root/reference/controller.py:97-262 verbatim (states, outputs, u_-1 and
the input moves stacked in one vector, equality rows for the recursions)
and solves it on the host with :func:`numpy_admm_qp`, a float64 ADMM of
the OSQP algorithm with OSQP's solution polishing. It shares no code with
the condensed float32 :class:`gpu_se_tpu.control.mpc.MPC`, which the
tests and the on-card smoke check against it.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


# ----------------------------------------------------------------------
def numpy_admm_qp(H, A, q, l, u, max_iter=5000, tol=1e-9, warm=None):
    """Independent float64 ADMM QP solver (OSQP algorithm, incl. adaptive
    rho) used as ground truth for the formulation-equivalence tests.

    The ADMM result is then polished as OSQP does: the active set read
    off the iterate is solved exactly (a KKT system), corrected until the
    point is feasible and its multipliers have the right signs — so the
    ADMM only has to get near the active set, and ``max_iter`` bounds
    the host time of the large (P = 300) problems.

    Returns ``(x, warm_state)`` so closed-loop callers can warm start.
    """
    n, m = H.shape[0], A.shape[0]
    sigma, alpha = 1e-6, 1.6
    eq = np.isclose(l, u)
    rho = np.where(eq, 1e3 * 0.1, 0.1)

    def factor(rho):
        K = H + sigma * np.eye(n) + A.T @ (rho[:, None] * A)
        return np.linalg.inv(K)

    K_inv = factor(rho)
    if warm is not None:
        x, z, y = (v.copy() for v in warm)
    else:
        x, z, y = np.zeros(n), np.zeros(m), np.zeros(m)
    l_c = np.where(np.isfinite(l), l, -1e30)
    u_c = np.where(np.isfinite(u), u, 1e30)
    for it in range(1, max_iter + 1):
        rhs = sigma * x - q + A.T @ (rho * z - y)
        xt = K_inv @ rhs
        x_new = alpha * xt + (1 - alpha) * x
        zt = A @ xt
        z_pre = alpha * zt + (1 - alpha) * z + y / rho
        z_new = np.clip(z_pre, l_c, u_c)
        y = rho * (z_pre - z_new)
        x, z = x_new, z_new
        if it % 50 == 0:
            prim = np.max(np.abs(A @ x - z))
            dual = np.max(np.abs(H @ x + q + A.T @ y))
            den_p = max(1e-10, np.abs(A @ x).max(), np.abs(z).max())
            den_d = max(1e-10, np.abs(H @ x).max(), np.abs(q).max(),
                        np.abs(A.T @ y).max())
            if prim < tol * max(1, den_p) and dual < tol * max(1, den_d):
                break
            factor_r = np.sqrt((prim / den_p) / max(dual / den_d, 1e-12))
            if factor_r > 5 or factor_r < 0.2:
                rho = np.clip(rho * factor_r, 1e-6, 1e6)
                K_inv = factor(rho)
    return _polish(H, A, q, l, u, x, z, y), (x, z, y)


def _polish(H, A, q, l, u, x, z, y, tol=1e-7, max_rounds=20):
    """OSQP's polish, iterated: guess the active set from the ADMM
    iterate, solve the equality-constrained KKT system exactly, then drop
    active rows whose multiplier has the wrong sign and add rows the
    solution violates, until the KKT conditions hold (a primal-dual
    active-set iteration). Returns the ADMM iterate if they never do."""
    eq = np.isclose(l, u)
    lower = eq | ((z - l) < -y)              # OSQP's active-set rule
    upper = ~lower & ((u - z) < y)
    n = H.shape[0]
    for _ in range(max_rounds):
        act = lower | upper
        A_act = A[act]
        k = A_act.shape[0]
        kkt = np.block([[H, A_act.T], [A_act, np.zeros((k, k))]])
        rhs = np.concatenate([-q, np.where(lower, l, u)[act]])
        try:
            sol = np.linalg.solve(kkt, rhs)
        except np.linalg.LinAlgError:
            return x
        x_p = sol[:n]
        y_p = np.zeros_like(y)
        y_p[act] = sol[n:]
        ax = A @ x_p
        slack = tol * max(1.0, np.abs(ax).max(initial=0.0))
        wrong = ~eq & ((lower & (y_p > tol)) | (upper & (y_p < -tol)))
        below = ~act & (ax < l - slack)
        above = ~act & (ax > u + slack)
        if not (wrong.any() or below.any() or above.any()):
            return x_p
        lower = (lower & ~wrong) | below
        upper = (upper & ~wrong) | above
    return x


# ----------------------------------------------------------------------
# Reference QP layout, transcribed from /root/reference/controller.py
# ----------------------------------------------------------------------
class ReferenceLayoutMPC:
    def __init__(self, P, M, Q, R, lin, ysp, y_bounds=None, u_bounds=None,
                 u_step_bounds=None):
        self.P, self.M, self.Q, self.R = P, M, Q, R
        self.model = lin
        Nx, Ni = lin.B.shape
        No = lin.C.shape[0]

        def unpack(bounds, dim):
            if bounds is None:
                return np.full(dim, -np.inf), np.full(dim, np.inf)
            lo, hi = [np.asarray(b, float) for b in zip(*bounds)]
            return lo, hi

        y_min, y_max = unpack(y_bounds, No)
        u_min, u_max = unpack(u_bounds, Ni)
        du_min, du_max = unpack(u_step_bounds, Ni)

        H = sp.block_diag([
            sp.csc_matrix(((P + 1) * Nx, (P + 1) * Nx)),
            sp.kron(sp.eye(P), Q),
            sp.csc_matrix((Ni, Ni)),
            sp.kron(sp.eye(M + 1), R),
        ], format="csc")
        q = np.hstack([
            np.zeros((P + 1) * Nx),
            np.kron(np.ones(P), -Q @ ysp),
            np.zeros((M + 2) * Ni),
        ])

        A_um1 = sp.hstack([
            sp.csc_matrix((Ni, (P + 1) * Nx + P * No)),
            sp.eye(Ni),
            sp.csc_matrix((Ni, (M + 1) * Ni)),
        ])

        A_state_x = sp.hstack([
            sp.vstack([
                -sp.eye(Nx),
                lin.A - sp.eye(Nx),
                sp.csc_matrix(((P - 1) * Nx, Nx)),
            ]),
            sp.vstack([
                sp.csc_matrix((Nx, P * Nx)),
                sp.kron(sp.eye(P, k=-1), lin.A) - sp.eye(P * Nx),
            ]),
        ])
        A_state_u = sp.vstack([
            sp.csc_matrix((Nx, (M + 2) * Ni)),
            sp.kron(
                sp.hstack([
                    sp.csc_matrix(([1], ([0], [0])), shape=(M, 1)),
                    sp.eye(M),
                    sp.csc_matrix((M, 1)),
                ]),
                lin.B,
            ),
            sp.csc_matrix(((P - M) * Nx, (M + 2) * Ni)),
        ])
        A_state = sp.hstack([A_state_x, sp.csc_matrix(((P + 1) * Nx, P * No)), A_state_u])
        b_state = np.hstack([np.zeros(Nx), np.zeros(P * Nx)])  # -x0 filled per step

        A_out_x = sp.kron(
            sp.hstack([sp.csc_matrix(([1], ([0], [0])), shape=(P, 1)), sp.eye(P)]),
            lin.C,
        )
        A_out_y = -sp.eye(P * No) + sp.eye(P * No, k=-No)
        A_out_u = sp.vstack([
            sp.kron(
                sp.hstack([
                    sp.csc_matrix(([1, 1], ([0, 0], [0, 1])), shape=(M, 2)),
                    sp.eye(M),
                ]),
                lin.D,
            ),
            sp.csc_matrix(((P - M) * No, (M + 2) * Ni)),
        ])
        A_output = sp.hstack([A_out_x, A_out_y, A_out_u])
        b_output = np.zeros(P * No)

        A_out_ineq = sp.hstack([
            sp.csc_matrix((P * No, (P + 1) * Nx)),
            sp.eye(P * No),
            sp.csc_matrix((P * No, (M + 2) * Ni)),
        ])
        A_steps = sp.hstack([
            sp.csc_matrix(((M + 1) * Ni, (P + 1) * Nx + P * No + Ni)),
            sp.eye((M + 1) * Ni),
        ])
        # reduced input constraint (the overwrite at controller.py:211-220)
        A_in = sp.hstack([
            sp.csc_matrix((Ni, (P + 1) * Nx + P * No)),
            sp.kron(np.ones((1, 2)), sp.eye(Ni)),
            sp.csc_matrix((Ni, M * Ni)),
        ])

        self.A = sp.vstack([A_um1, A_state, A_output, A_out_ineq, A_steps, A_in]).toarray()
        self.l = np.hstack([
            np.zeros(Ni), b_state, b_output,
            np.kron(np.ones(P), y_min), np.kron(np.ones(M + 1), du_min), u_min,
        ])
        self.u = np.hstack([
            np.zeros(Ni), b_state, b_output,
            np.kron(np.ones(P), y_max), np.kron(np.ones(M + 1), du_max), u_max,
        ])
        self.H = H.toarray()
        self.q = q
        self.Nx, self.Ni, self.No = Nx, Ni, No
        self.y_predicted = None
        self._warm = None

    def step(self, x0, um1, y0):
        Nx, Ni, No, P = self.Nx, self.Ni, self.No, self.P
        l, u = self.l.copy(), self.u.copy()
        l[:Ni] = um1
        u[:Ni] = um1
        l[Ni:Ni + Nx] = -x0
        u[Ni:Ni + Nx] = -x0
        bias = (y0 - self.y_predicted) if self.y_predicted is not None else np.zeros_like(y0)
        l[Ni + (P + 1) * Nx:Ni + (P + 1) * Nx + P * No] = np.tile(-bias, P)
        u[Ni + (P + 1) * Nx:Ni + (P + 1) * Nx + P * No] = np.tile(-bias, P)
        x, self._warm = numpy_admm_qp(self.H, self.A, self.q, l, u, warm=self._warm)
        m = (P + 1) * Nx + P * No + Ni
        ctrl = x[m:m + Ni] + um1
        self.y_predicted = x[(P + 1) * Nx:(P + 1) * Nx + No] - bias
        return ctrl
