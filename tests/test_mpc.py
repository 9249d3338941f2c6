"""MPC tests.

The keystone check rebuilds the reference's sparse simultaneous-form QP
layout verbatim (/root/reference/controller.py:97-262), solves it with the
generic DenseQP solver, and asserts the condensed MPC produces the same
control moves and one-step-ahead predictions — proving the condensation
preserves the reference optimizer exactly (including the u0-only input
constraint quirk and the bias integral action).

Also: closed-loop tank regression (cf.
/root/reference/tests/mpc_tests/tank_simulation_test.py) and solver-failure
contract.
"""
import numpy as np
import pytest

from gpu_se_tpu import models
from gpu_se_tpu.control import MPC, DenseQP, QPSettings, SOLVED
from gpu_se_tpu.control.reference import ReferenceLayoutMPC
from gpu_se_tpu.models import LinearModel, TankModel, create_linear_model


def random_stable_lin_model(seed, nx=2, ni=2, no=2, dt=1.0, with_d=True):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(nx, nx))
    A = 0.8 * A / np.max(np.abs(np.linalg.eigvals(A)))
    B = rng.normal(size=(nx, ni))
    C = rng.normal(size=(no, nx))
    D = rng.normal(size=(no, ni)) * (0.3 if with_d else 0.0)
    return LinearModel(A, B, C, D, dt, np.zeros(nx), np.zeros(ni),
                       np.zeros(nx), np.zeros(no))


@pytest.mark.parametrize("with_d", [False, True])
def test_condensed_matches_reference_layout(with_d):
    """Condensed MPC == reference simultaneous-form QP, over multiple
    steps with active bias correction."""
    P_h, M_h = 8, 4
    lin = random_stable_lin_model(0, with_d=with_d)
    Q = np.diag([1.0, 2.0])
    R = np.diag([0.5, 0.5])
    ysp = np.array([1.0, -0.5])
    u_bounds = [np.array([-2.0, 2.0]), np.array([-2.0, 2.0])]

    ref = ReferenceLayoutMPC(P_h, M_h, Q, R, lin, ysp, u_bounds=u_bounds)
    ours = MPC(P_h, M_h, Q, R, lin, ysp, u_bounds=u_bounds,
               qp_settings=QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000))

    rng = np.random.default_rng(1)
    x = np.array([0.5, -0.3])
    um1 = np.zeros(2)
    for step_i in range(4):
        y0 = lin.C @ x + lin.D @ um1 + rng.normal(scale=0.01, size=2)
        u_ref = ref.step(x, um1, y0)
        u_ours = ours.step(x, um1, y0)
        np.testing.assert_allclose(u_ours, u_ref, atol=2e-3), f"step {step_i}"
        np.testing.assert_allclose(
            np.asarray(ours.y_predicted), ref.y_predicted, atol=2e-3
        )
        um1 = u_ours
        x = lin.A @ x + lin.B @ um1 + rng.normal(scale=0.01, size=2)


def test_condensed_matches_reference_layout_with_y_and_step_bounds():
    P_h, M_h = 6, 3
    lin = random_stable_lin_model(5, with_d=False)
    Q = np.eye(2)
    R = 0.1 * np.eye(2)
    ysp = np.array([0.5, 0.5])
    y_bounds = [np.array([-3.0, 3.0]), np.array([-3.0, 3.0])]
    du_bounds = [np.array([-0.5, 0.5]), np.array([-0.5, 0.5])]
    u_bounds = [np.array([-1.5, 1.5]), np.array([-1.5, 1.5])]

    ref = ReferenceLayoutMPC(P_h, M_h, Q, R, lin, ysp, y_bounds, u_bounds, du_bounds)
    ours = MPC(P_h, M_h, Q, R, lin, ysp, y_bounds, u_bounds, du_bounds,
               qp_settings=QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000))

    x = np.array([0.2, -0.4])
    um1 = np.zeros(2)
    for _ in range(3):
        y0 = lin.C @ x
        u_ref = ref.step(x, um1, y0)
        u_ours = ours.step(x, um1, y0)
        np.testing.assert_allclose(u_ours, u_ref, atol=5e-3)
        um1 = u_ours
        x = lin.A @ x + lin.B @ um1


def test_tank_closed_loop():
    """Nonlinear tank settles to setpoint under MPC with bias correction
    (cf. /root/reference/tests/mpc_tests/tank_simulation_test.py)."""
    end_time = 80
    ts = np.linspace(0, end_time, end_time * 100)
    dt = ts[1]
    dt_control = 1.0

    X0 = np.array([50.0])
    tank = TankModel(X0.copy(), linear=False)
    lin = create_linear_model(
        TankModel(np.array([50.0]), linear=False),
        x_bar=np.array([50.0]), u_bar=np.array([10.0]), T=dt_control,
    )
    r = np.array([100.0])
    K = MPC(P=20, M=8, Q=np.diag([10.0]), R=np.diag([0.0]),
            lin_model=lin, ysp=lin.yn2d(r))

    X_op, U_op = np.array([50.0]), np.array([10.0])
    Y_op = np.array([50.0])
    us = [U_op.copy()]
    ys = [Y_op.copy()]
    biass = []
    t_next = 0.0
    for t in ts[1:]:
        tank.step(dt, us[-1])
        ys.append(tank.outputs(us[-1]).copy())
        if t > t_next:
            if K.y_predicted is not None:
                biass.append(ys[-1] - Y_op - K.y_predicted)
            u = K.step(tank.X - X_op, us[-1] - U_op, ys[-1] - Y_op)
            us.append(u + U_op)
            t_next += dt_control
        else:
            us.append(us[-1])

    ys = np.array(ys)
    biass = np.array(biass)
    # settles to the setpoint (cf. test_nonlinear_tank_SS, abs=1e-3)
    np.testing.assert_allclose(ys[5000:].ravel(), np.full(len(ys) - 5000, r[0]), atol=1e-3)
    # bias settles to a constant (cf. test_nonlinear_tank_bias); there is
    # one bias sample per control step (~80 total), so window on the
    # second half — biass[100:] would be empty and the assert vacuous
    late_bias = biass[len(biass) // 2:]
    assert late_bias.size > 0
    np.testing.assert_allclose(late_bias - late_bias.mean(), 0.0, atol=1e-6)


def test_solver_failure_raises():
    """Infeasible bounds must raise ValueError for the caller-side
    fallback (cf. /root/reference/controller.py:270-271)."""
    lin = random_stable_lin_model(2, with_d=False)
    # u0 >= 1 conflicts with du_0 <= -5 (at um1 = 0): primal infeasible
    K = MPC(5, 2, np.eye(2), np.eye(2), lin, np.zeros(2),
            u_bounds=[np.array([1.0, np.inf]), np.array([1.0, np.inf])],
            u_step_bounds=[np.array([-np.inf, -5.0]), np.array([-np.inf, -5.0])])
    with pytest.raises(ValueError):
        K.step(np.zeros(2), np.zeros(2), np.zeros(2))


def test_input_clamp():
    lin = random_stable_lin_model(3, with_d=False)
    K = MPC(5, 2, np.eye(2), np.eye(2), lin, np.zeros(2))
    u = K.step(np.full(2, 1e12), np.zeros(2), np.zeros(2))  # clamped to 1e10
    assert np.isfinite(u).all()


def test_canonical_bioreactor_rig_mpc():
    """The canonical rig MPC (cf. /root/reference/sim_base.py:75-86) at
    dt_control=1: P=300, M=200 — solves and returns finite controls."""
    reactor = models.Bioreactor(
        X0=models.Bioreactor.find_SS(
            np.array([0.06, 0.2]), np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0])
        ),
        high_N=False,
    )
    lin = create_linear_model(
        reactor,
        x_bar=models.Bioreactor.find_SS(
            np.array([0.04, 0.1]), np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0])
        ),
        u_bar=np.array([0.04, 0.1]),
        T=1.0,
    )
    lin.select_subset(states=[0, 2], inputs=[0, 1], outputs=[0, 2])
    K = MPC(
        P=300, M=200, Q=np.diag([0.1, 1.0]), R=np.diag([1.0, 1.0]),
        lin_model=lin,
        ysp=lin.yn2d(np.array([280.0, 850.0]), subselect=False),
        u_bounds=[
            np.array([0, np.inf]) - lin.u_bar[0],
            np.array([0, np.inf]) - lin.u_bar[1],
        ],
    )
    x0 = lin.xn2d(reactor.X)
    u = K.step(x0, np.array([0.06, 0.2]) - lin.u_bar, lin.yn2d(reactor.outputs(None)))
    assert np.isfinite(u).all()
    # input bound (u >= 0 in natural units) respected
    assert np.all(u + lin.u_bar >= -1e-5)


def test_extract_matches_float64():
    """The device-side extraction of the control move runs in full
    float32 (pinned: a default-precision GPU matmul may use TF32): it
    matches the float64 product to float32 rounding."""
    import jax.numpy as jnp

    from gpu_se_tpu.control.mpc import _extract

    rng = np.random.default_rng(0)
    ctrl_map = rng.standard_normal((2, 402))
    theta0_w = rng.standard_normal((2, 402))
    v = rng.standard_normal(402)
    consts = {"ctrl_map": jnp.asarray(ctrl_map, jnp.float32),
              "theta0_w": jnp.asarray(theta0_w, jnp.float32)}
    ctrl, y1 = _extract(consts, jnp.asarray(v, jnp.float32))
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa: E731
    for got, mat in ((ctrl, ctrl_map), (y1, theta0_w)):
        want = f32(mat) @ f32(v)
        scale = np.abs(f32(mat)) @ np.abs(f32(v))
        assert np.all(np.abs(np.asarray(got, np.float64) - want)
                      <= 402 * 2.0 ** -24 * scale)


def test_device_step_matches_host_step():
    """make_device_step (all float32 on device, precision pinned) gives
    the host shell's float64-prepared control move to solver accuracy."""
    import jax.numpy as jnp

    from gpu_se_tpu.control import mpc as mpc_mod

    lin = random_stable_lin_model(3)
    K = MPC(6, 3, np.eye(2), 0.1 * np.eye(2), lin, np.array([0.5, -0.2]),
            u_bounds=[np.array([-1.0, 1.0]), np.array([-1.0, 1.0])],
            qp_settings=QPSettings(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000))
    x0, um1, y0 = np.array([0.3, -0.1]), np.zeros(2), np.array([0.1, 0.2])
    u_host = K.step(x0, um1, y0)
    consts, step_fn = mpc_mod.make_device_step(K)
    n_d, m = (K.M + 1) * K.Ni, int(K.qp.m)
    ctrl, _, sol = step_fn(consts, jnp.asarray(x0, jnp.float32),
                           jnp.asarray(um1, jnp.float32),
                           jnp.zeros(2, jnp.float32),
                           jnp.zeros(n_d, jnp.float32), jnp.zeros(m, jnp.float32))
    assert int(sol.status) == SOLVED
    np.testing.assert_allclose(np.asarray(ctrl), u_host, atol=1e-4)
