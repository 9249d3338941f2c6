"""Closed-loop simulation harness — the canonical bioreactor rig.

Mirrors /root/reference/sim_base.py: ``get_parts`` builds the plant /
linear model / MPC / filter quartet, ``get_noise`` the canonical noise
mixtures, ``performance`` the time-weighted ISE metric, and
``Simulation`` the event loop with independent predict/control timers.

The plant truth integrates on host (numpy, cheap); the filter and the
MPC QP run on the accelerator through their jitted cores. A fully
on-device ``lax.scan`` loop lives in ``gpu_se_tpu.sim.loop``.
"""
from __future__ import annotations

import numpy as np
import scipy.integrate

from gpu_se_tpu import models
from gpu_se_tpu.control import MPC
from gpu_se_tpu.distributions import (
    DeterministicGaussianSum,
    GaussianSum,
    MultivariateGaussianSum,
)
from gpu_se_tpu.filters import GaussianSumUnscentedKalmanFilter, ParticleFilter
from gpu_se_tpu.models import Bioreactor, create_linear_model


def get_parts(dt_control=1, N_particles=2 * 15, gpu=True, pf=True, seed=0):
    """Canonical closed-loop rig (cf. /root/reference/sim_base.py:10-114).

    ``gpu`` is accepted for API parity and ignored: the single JAX code
    path serves every backend (the reference used it to pick the CuPy
    twin classes). The reference's default ``N_particles=2*15`` (=30, a
    likely typo for 2**15) is preserved verbatim.
    """
    del gpu
    bioreactor = Bioreactor(
        X0=Bioreactor.find_SS(
            np.array([0.06, 0.2]),
            #            Ng,       Nx,       Nfa, Ne, Nh
            np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0]),
        ),
        high_N=False,
    )

    lin_model = create_linear_model(
        bioreactor,
        x_bar=Bioreactor.find_SS(
            np.array([0.04, 0.1]),
            np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0]),
        ),
        u_bar=np.array([0.04, 0.1]),
        T=dt_control,
    )
    lin_model.select_subset(
        states=[0, 2],  # Cg, Cfa
        inputs=[0, 1],  # Fg_in, Fm_in
        outputs=[0, 2],  # Cg, Cfa
    )

    K = MPC(
        P=int(300 // dt_control),
        M=max(int(200 // dt_control), 1),
        Q=np.diag([0.1, 1]),
        R=np.diag([1, 1]),
        lin_model=lin_model,
        ysp=lin_model.yn2d(np.array([280, 850]), subselect=False),
        u_bounds=[
            np.array([0, np.inf]) - lin_model.u_bar[0],
            np.array([0, np.inf]) - lin_model.u_bar[1],
        ],
    )

    filter_cls = ParticleFilter if pf else GaussianSumUnscentedKalmanFilter
    state_pdf, measurement_pdf = get_noise()
    x0, _ = get_noise()
    x0.dist = x0.dist.replace(
        means=x0.dist.means + np.asarray(bioreactor.X)[None, :].astype(np.float32)
    )
    est = filter_cls(
        f=Bioreactor.homeostatic_DEs,
        g=Bioreactor.static_outputs,
        N_particles=N_particles,
        x0=x0,
        state_pdf=state_pdf,
        measurement_pdf=measurement_pdf,
        seed=seed,
    )
    return bioreactor, lin_model, K, est


def get_noise(lib=None, deterministic=False):
    """Canonical state/measurement noise mixtures
    (cf. /root/reference/sim_base.py:117-161). ``lib`` accepted and
    ignored (numpy/cupy switch in the reference)."""
    del lib
    distribution = DeterministicGaussianSum if deterministic else MultivariateGaussianSum
    state_pdf = distribution(
        means=np.zeros(shape=(2, 5)),
        covariances=np.array(
            [
                np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6]),
            ]
        ),
        weights=np.array([0.75, 0.25]),
    )
    measurement_pdf = distribution(
        means=np.array([[1e-1, 0], [0, -1e-1]]),
        covariances=np.array(
            [[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]
        ),
        weights=np.array([0.85, 0.15]),
    )
    return state_pdf, measurement_pdf


def filter_rig():
    """The open-loop filter rig of the benchmarks (cf.
    /root/reference/results/pf_openloop/pf_run_seq.py): the bioreactor
    at a fixed operating point ``x_ss``, an initial-state mixture around
    it, the canonical noise mixtures, the input ``u`` and the noise-free
    measurement ``z`` at ``x_ss``.

    Returns ``(x0, state_pdf, measurement_pdf, u, z)`` — the mixtures as
    :class:`GaussianSum` pytrees, ``u`` and ``z`` as float32 arrays.
    """
    import jax.numpy as jnp

    x_ss = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
    x0 = GaussianSum.create(
        np.stack([x_ss, x_ss]),
        np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
        np.array([0.75, 0.25]),
    )
    state_pdf, measurement_pdf = get_noise()
    u = np.array([0.06, 0.2])
    z = models.static_outputs(x_ss, u, xp=np)
    return (x0, state_pdf.dist, measurement_pdf.dist,
            jnp.asarray(u, jnp.float32), jnp.asarray(z, jnp.float32))


def performance(ys, r, ts):
    """Time-weighted ISE (the reference's docstring says ITAE; the code
    integrates (y - r)^2 * t — replicated faithfully,
    cf. /root/reference/sim_base.py:164-185)."""
    se = (np.asarray(ys) - np.asarray(r)) ** 2
    return sum(
        scipy.integrate.simpson(se_ax * ts, x=ts) for se_ax in np.rollaxis(se, 1)
    )


def get_random_io(rng=None):
    """Random system input/output draws (cf. /root/reference/sim_base.py:188-204)."""
    rng = rng or np.random.default_rng()
    u = np.array([rng.uniform(0, 0.1), rng.uniform(0, 0.2)])
    y = np.array([rng.uniform(0.25, 0.3), rng.uniform(0.8, 0.9)])
    return u, y


class Simulation:
    """Closed-loop simulation with independent predict/control periods
    (cf. /root/reference/sim_base.py:207-309)."""

    def __init__(self, N_particles, dt_control, dt_predict, end_time=50, pf=True,
                 seed=0):
        self.ts = np.linspace(0, end_time, int(end_time * 10))
        self.dt = self.ts[1]
        self.dt_control = dt_control
        self.dt_predict = dt_predict

        self.bioreactor, self.lin_model, self.K, self.f = get_parts(
            dt_control=dt_control, N_particles=N_particles, pf=pf, seed=seed
        )

        self.state_pdf, self.measurement_pdf = get_noise()
        # independent plant-noise streams, pre-drawn for the whole horizon
        # in two batched device calls (the reference draws eagerly every
        # step — ~1000 device round trips per run, /root/reference/sim_base.py:281-284)
        import jax

        n_steps = len(self.ts)
        self._state_noise = np.asarray(
            self.state_pdf.dist.draw(jax.random.PRNGKey(seed + 101), (n_steps,)),
            dtype=float,
        )
        self._meas_noise = np.asarray(
            self.measurement_pdf.dist.draw(jax.random.PRNGKey(seed + 202), (n_steps,)),
            dtype=float,
        )

        self.us = [np.array([0.06, 0.2])]
        self.xs = [self.bioreactor.X.copy()]
        self.ys = [self.bioreactor.outputs(self.us[-1])]
        self.ys_meas = [self.bioreactor.outputs(self.us[-1])]
        self.xs_f = [np.asarray(self.f.point_estimate(), dtype=float)]
        self.ys_f = [
            np.asarray(
                models.static_outputs(self.xs_f[-1], self.us[-1], xp=np), dtype=float
            )
        ]
        self.covariance_point_size = [float(self.f.point_covariance())]

        self.biass = []
        self.performance = None
        self.mpc_frac = None
        self.predict_count, self.update_count = 0, 0

    def simulate(self, progress=False):
        t_next_control, t_next_predict = 0.0, 0.0
        mpc_converged, mpc_no_converged = 0, 0
        iterator = self.ts[1:]
        if progress:
            import tqdm

            iterator = tqdm.tqdm(iterator)
        for t in iterator:
            if t > t_next_predict:
                self.f.predict(self.us[-1], self.dt)
                self.predict_count += 1
                t_next_predict += self.dt_predict

            if t > t_next_control:
                u_prev = self.us[-1].copy()
                if self.K.y_predicted is not None:
                    self.biass.append(
                        self.lin_model.yn2d(self.ys_meas[-1]) - self.K.y_predicted
                    )
                z = np.asarray(self.ys_meas[-1])[self.lin_model.outputs]
                self.f.update(self.us[-1], z)
                self.f.resample()
                self.update_count += 1

                self.xs_f.append(np.asarray(self.f.moments()[0], dtype=float))
                try:
                    u = self.K.step(
                        self.lin_model.xn2d(self.xs_f[-1]),
                        self.lin_model.un2d(self.us[-1]),
                        self.lin_model.yn2d(self.ys_meas[-1]),
                    )
                    mpc_converged += 1
                except ValueError:
                    u = np.array([0.06, 0.2])
                    mpc_no_converged += 1
                u_prev[self.lin_model.inputs] = self.lin_model.ud2n(u)
                self.us.append(u_prev.copy())
                t_next_control += self.dt_control
            else:
                self.us.append(self.us[-1])

            self.bioreactor.step(self.dt, self.us[-1])
            step_i = len(self.xs)
            self.bioreactor.X = self.bioreactor.X + self._state_noise[step_i]
            outputs = self.bioreactor.outputs(self.us[-1])
            self.ys.append(outputs.copy())
            outputs = outputs.copy()
            outputs[self.lin_model.outputs] += self._meas_noise[step_i]
            self.ys_meas.append(outputs)
            self.xs.append(self.bioreactor.X.copy())
            # moments() is one fused dispatch, cached between filter
            # updates — the per-substep estimate/covariance reads are
            # value-identical to point_estimate()/point_covariance() but
            # cost no device round trip when the state hasn't changed
            est, cov = self.f.moments()
            self.ys_f.append(
                np.asarray(
                    models.static_outputs(
                        np.asarray(est, dtype=float),
                        self.us[-1],
                        xp=np,
                    ),
                    dtype=float,
                )
            )
            self.covariance_point_size.append(float(cov))

        self.us = np.array(self.us)
        self.xs = np.array(self.xs)
        self.ys = np.array(self.ys)
        self.ys_meas = np.array(self.ys_meas)
        self.xs_f = np.array(self.xs_f)
        self.ys_f = np.array(self.ys_f)
        self.covariance_point_size = np.array(self.covariance_point_size)
        self.performance = performance(
            self.ys[:, self.lin_model.outputs], self.ys_f, self.ts
        )
        total = mpc_converged + mpc_no_converged
        self.mpc_frac = mpc_converged / total if total else None


def run_no_noise_loop(K, lin_model, end_time=50, dt_control=1):
    """The no_noise closed loop, verbatim structure
    (cf. /root/reference/results/bioreactor_closedloop/no_noise.py:8-51):
    the plant, started at its steady state, is driven by the controller
    ``K`` for ``end_time`` minutes. Returns ``(ts, us, xs, ys)``."""
    ts = np.linspace(0, end_time, end_time * 10)
    dt = ts[1]
    bioreactor = Bioreactor(
        X0=Bioreactor.find_SS(
            np.array([0.06, 0.2]), np.array([260 / 180, 640 / 24.6, 1000 / 116, 0, 0])
        ),
        high_N=False,
    )
    us = [np.array([0.06, 0.2])]
    xs = [bioreactor.X.copy()]
    ys = [bioreactor.outputs(us[-1])]
    t_next = 0.0
    for t in ts[1:]:
        if t > t_next:
            u_temp = us[-1].copy()
            u = K.step(
                lin_model.xn2d(xs[-1]),
                lin_model.un2d(us[-1]),
                lin_model.yn2d(ys[-1]),
            )
            u_temp[lin_model.inputs] = lin_model.ud2n(u)
            us.append(u_temp.copy())
            t_next += dt_control
        else:
            us.append(us[-1])
        bioreactor.step(dt, us[-1])
        ys.append(bioreactor.outputs(us[-1]))
        xs.append(bioreactor.X.copy())
    return ts, np.array(us), np.array(xs), np.array(ys)
