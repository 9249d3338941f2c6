"""MPC latency benchmark: closed-loop K.step timings at dt_control=0.1
(P=3000, M=2000), with the run-sequence/pacf methodology, plus
DEVICE-SIDE latency attribution: ``device_solve_ms`` times a lax.scan of
warm-started solves in ONE dispatch, separating the QP solve itself from
the host prep and dispatch round trip that ``K.step`` adds end to end.

Re-creation of /root/reference/results/bioreactor_closedloop/mpc_run_seq.py
(:29,79,111) with the attribution the reference could not need (its OSQP
ran in-process).
"""
import time

import numpy as np

from gpu_se_tpu import sim
from gpu_se_tpu.utils import PickleJar, max_abs_pacf
from results._common import save_fig


@PickleJar.pickle(path="bioreactor/mpc_run_seq")
def mpc_run_seq(n_runs=1000, dt_control=0.1):
    """Wall-clock times of ``n_runs`` warm-started closed-loop MPC solves
    (cf. mpc_run_seq.py:20-79 in the reference)."""
    end_time = 50
    ts = np.linspace(0, end_time, int(end_time * 10))
    dt = ts[1]
    bioreactor, lin_model, K, _ = sim.get_parts(dt_control=dt_control)

    us = [np.array([0.06, 0.2])]
    xs = [bioreactor.X.copy()]
    ys = [bioreactor.outputs(us[-1])]

    times = []
    while len(times) < n_runs:
        for t in ts[1:]:
            u_temp = us[-1].copy()
            t0 = time.perf_counter()
            try:
                u = K.step(
                    lin_model.xn2d(xs[-1]),
                    lin_model.un2d(us[-1]),
                    lin_model.yn2d(ys[-1]),
                )
            except ValueError:
                u = np.array([0.06, 0.2]) - lin_model.u_bar
            times.append(time.perf_counter() - t0)
            u_temp[lin_model.inputs] = lin_model.ud2n(u)
            us.append(u_temp.copy())
            bioreactor.step(dt, us[-1])
            ys.append(bioreactor.outputs(us[-1]))
            xs.append(bioreactor.X.copy())
            if len(times) >= n_runs:
                break
    return np.array(times)


def device_solve_ms(dt_control=0.1, k1=2, k2=10, reps=3):
    """Device-side ms/solve via scan slopes (an in-jit scalar fetched
    via float() forces completion). Returns
    (ms_per_solve, cold_start_admm_iterations)."""
    import time

    import jax
    import jax.numpy as jnp

    from gpu_se_tpu.control import mpc as mpc_mod

    bioreactor, lin_model, K, _ = sim.get_parts(dt_control=dt_control)
    consts, step_fn = mpc_mod.make_device_step(K)
    n_d = (K.M + 1) * K.Ni
    m_rows = int(K.qp.m)

    def body(carry, i):
        x0, um1, bias, wv, wy = carry
        ctrl, _y, sol = step_fn(consts, x0, um1, bias, wv, wy)
        x0n = x0 + 0.005 * jnp.tanh(ctrl) + 1e-4 * i
        return (x0n, ctrl, bias, sol.x, sol.y), sol.iterations

    def make(k):
        @jax.jit
        def scank(consts, x0):
            carry = (
                x0, jnp.zeros(K.Ni, jnp.float32), jnp.zeros(K.No, jnp.float32),
                jnp.zeros(n_d, jnp.float32), jnp.zeros(m_rows, jnp.float32),
            )
            carry, iters = jax.lax.scan(
                body, carry, jnp.arange(k, dtype=jnp.float32)
            )
            return jnp.sum(carry[1]) + 0.0 * jnp.mean(iters)
        return scank

    seed = int(time.time() * 1000) % (2 ** 31)
    key = jax.random.PRNGKey(seed)
    times = {}
    for k in (k1, k2):
        fn = make(k)
        ts = []
        for rep in range(reps + 1):
            sub = jax.random.fold_in(key, k * 100 + rep)
            x0 = 0.05 * jax.random.normal(sub, (K.Nx,), jnp.float32)
            _ = float(jnp.sum(x0))
            t0 = time.perf_counter()
            _ = float(fn(consts, x0))  # scalar fetch forces completion
            ts.append((time.perf_counter() - t0) * 1e3)
        times[k] = float(np.median(ts[1:]))
    ms = (times[k2] - times[k1]) / (k2 - k1)
    _, _, sol = step_fn(consts, jnp.asarray([0.01, -0.01], jnp.float32),
                        jnp.zeros(K.Ni, jnp.float32), jnp.zeros(K.No, jnp.float32),
                        jnp.zeros(n_d, jnp.float32), jnp.zeros(m_rows, jnp.float32))
    return ms, float(sol.iterations)


def plot(n_runs=1000):
    import matplotlib.pyplot as plt

    times = mpc_run_seq(n_runs)
    times = times[1:]  # drop the compile call
    print(f"median MPC solve (end-to-end K.step): {np.median(times) * 1000:.2f} ms")
    print(f"max |pacf|: {max_abs_pacf(times):.3f} (gate: < 0.2)")
    dev_ms, dev_iters = device_solve_ms()
    print(f"device-side QP solve: {dev_ms:.2f} ms ({1e3 / dev_ms:.0f} solves/s, "
          f"mean {dev_iters:.0f} ADMM iterations) — the end-to-end gap is "
          "host prep + dispatch round trip")
    fig, axes = plt.subplots(1, 2, figsize=(12.5, 5))
    axes[0].plot(times * 1000, "k.", markersize=2)
    axes[0].set_xlabel("run"); axes[0].set_ylabel("solve time (ms)")
    axes[1].plot(times[:-1] * 1000, times[1:] * 1000, "k.", markersize=2)
    axes[1].set_xlabel("run i (ms)"); axes[1].set_ylabel("run i+1 (ms)")
    return save_fig("mpc_run_seq.png")


if __name__ == "__main__":
    plot()
