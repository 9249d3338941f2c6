"""On-card smoke test of the state-estimation and MPC main path.

Runs, on one GPU, the phases below through the package's normal entry
points, at the sizes the reference's users run, and checks each against
the repo's plain reference:

* ``device``  — what JAX sees, the card's name and power limit
  (``nvidia-smi``, read by a child process that stays off JAX) and the
  compile-cache directory; fails unless the platform is ``gpu``.
* ``pf``      — the bench rig (bioreactor, N = 2^20, nx = 5, dt = 0.1):
  the structure-of-arrays step compiled, then 10 chained steps (a smoke
  timing, not a benchmark). On the card the ancestors and resampled rows
  must equal ``systematic_resample_indices`` + ``sorted_row_gather`` fed
  the same weights and ``r`` bitwise; the pre-resample weights must match
  the CPU run of the same step and key to 1e-4 relative.
* ``gsukf``   — the GSUKF step at 2^18 Gaussians: its bank resample must
  equal the plain reference bitwise, its point estimate the CPU run to
  1e-3 relative.
* ``mpc``     — the canonical MPC (dt_control = 1: P = 300, M = 200) in
  the no-noise closed loop for 10 simulated minutes against
  ``ReferenceLayoutMPC``, the independent float64 host solver, driven
  through the same loop in a CPU-only child process started first:
  max|u - u_ref| <= 1e-4.
* ``closed_loop`` — ``sim.Simulation`` with a 2^20-particle filter:
  finite ITSE and every MPC step solved.

``--four`` runs only the multi-device phase: the sharded PF and GSUKF
steps on a 4-device mesh against the same steps on a 1-device mesh.

Each phase prints one JSON line; the last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Any failure exits non-zero. Run from the repo root: ``python chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import functools
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback

import numpy as np

import jax
import jax.numpy as jnp

from gpu_se_tpu import sim
from gpu_se_tpu.config import enable_compile_cache
from gpu_se_tpu.filters import gs_ukf
from gpu_se_tpu.filters import particle as pf_core
from gpu_se_tpu.filters import particle_tiled as pft
from gpu_se_tpu.filters.resampling import (
    sorted_row_gather,
    systematic_resample_indices,
)
from gpu_se_tpu.models import bioreactor as bio

DT = 0.1
PF_KERNELS = ("xla", "triton")


class SmokeFailure(AssertionError):
    """A phase's output broke its contract."""


def _require(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def _emit(record: dict):
    print(json.dumps(record), flush=True)


def nvidia_smi() -> str:
    """``name, power.limit`` of the card, read by a child process."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip()


# ----------------------------------------------------------------------
def device_phase(smi: str, platform: str = "gpu") -> dict:
    """``smi`` is the card's ``nvidia-smi`` line (:func:`nvidia_smi`)."""
    devs = jax.devices()
    _require(devs[0].platform == platform,
             f"platform {devs[0].platform!r}, expected {platform!r}")
    return {
        "nvidia_smi": smi,
        "devices": [str(d) for d in devs],
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "compile_cache_dir": jax.config.jax_compilation_cache_dir,
    }


def _timed_steps(step, state, reps: int):
    """Compile ``step`` for ``state``, run it once, then ``reps`` chained
    steps each ending in ``block_until_ready``."""
    t0 = time.perf_counter()
    compiled = step.lower(state).compile()
    compile_s = time.perf_counter() - t0
    state = compiled(state)
    jax.block_until_ready(state)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = compiled(state)
        jax.block_until_ready(state)
        times.append(time.perf_counter() - t0)
    return compiled, state, compile_s, times


def _rel_err(got, want, floor_frac: float = 0.0) -> float:
    """max |got - want| / |want| over entries with |want| above
    ``floor_frac`` times the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mask = np.abs(want) > floor_frac * np.abs(want).max()
    return float(np.max(np.abs(got - want)[mask] / np.abs(want)[mask]))


def pf_phase(n: int, device, cpu, *, kernels=PF_KERNELS, reps: int = 10,
             seed: int = 0) -> dict:
    x0, state_pdf, meas_pdf, u, z = sim.filter_rig()
    f = functools.partial(bio.homeostatic_des, xp=jnp)
    g = functools.partial(bio.static_outputs, xp=jnp)
    dt = jnp.float32(DT)
    state = jax.device_put(pft.init(jax.random.PRNGKey(seed), n, x0), device)

    def predict_update(s):
        _, kn, kr = jax.random.split(s.key, 3)
        xn, w = pft.predict_update(s.x, u, z, dt, f, g, state_pdf, meas_pdf, kn)
        return xn, w, jax.random.uniform(kr, (), dtype=jnp.float32)

    @jax.jit
    def reference(xn, w, r):
        idx = systematic_resample_indices(w, r)
        return idx, sorted_row_gather(xn.T, idx)

    xn, w, r = jax.jit(predict_update)(state)
    idx_ref, rows_ref = reference(xn, w, r)
    out = {"n": n, "nx": int(xn.shape[0]),
           "timing": "smoke timing, not a benchmark"}
    for kernel in kernels:
        step = jax.jit(functools.partial(
            pft.step, u=u, z=z, dt=dt, f=f, g=g, state_pdf=state_pdf,
            measurement_pdf=meas_pdf, kernel=kernel))
        compiled, last, compile_s, times = _timed_steps(step, state, reps)
        _require(bool(jnp.isfinite(last.x).all()), f"{kernel}: non-finite state")
        x_new, anc = jax.jit(functools.partial(pft.resample, kernel=kernel))(
            xn, w, r)
        _require(np.array_equal(anc, idx_ref),
                 f"{kernel}: ancestors differ from the plain reference")
        _require(np.array_equal(np.asarray(x_new).T, rows_ref),
                 f"{kernel}: rows differ from the plain reference")
        out[kernel] = {
            "compile_s": compile_s,
            "median_step_ms": 1e3 * float(np.median(times)),
            # the fused step may contract the predict/update arithmetic
            # differently from the stages compiled apart, so this is
            # reported, not required
            "step_equals_stages": bool(
                np.array_equal(compiled(state).x, x_new)),
        }
    # the default step picks the fused kernel on a CUDA GPU, XLA elsewhere
    auto = jax.jit(functools.partial(
        pft.step, u=u, z=z, dt=dt, f=f, g=g, state_pdf=state_pdf,
        measurement_pdf=meas_pdf))(state)
    picked = "triton" if device.platform == "gpu" else "xla"
    if picked in kernels:
        _require(np.array_equal(
            auto.x, jax.jit(functools.partial(
                pft.step, u=u, z=z, dt=dt, f=f, g=g, state_pdf=state_pdf,
                measurement_pdf=meas_pdf, kernel=picked))(state).x),
            f"the default step is not the {picked} step")
    out["default_kernel"] = picked

    # the same step on the CPU from the same state and key. The predicted
    # particles agree to float32 rounding (row-normwise); the update is
    # compared on identical particles, because one ulp of a predicted
    # output (~3e-5 at y ~ 280) moves a deep weight exp(-quad/2) by up to
    # ~1.5e-3 relative — reported end to end, bounded stage by stage
    xn_cpu, w_cpu, _ = jax.jit(predict_update)(
        jax.device_put(jax.device_get(state), cpu))
    w_cpu_same_x = jax.jit(lambda xn: meas_pdf.pdf_t(
        z.reshape(-1, 1) - g(xn, u)))(jax.device_put(jax.device_get(xn), cpu))
    xn, xn_cpu = np.asarray(xn, np.float64), np.asarray(xn_cpu, np.float64)
    out["state_row_err_vs_cpu"] = float(np.max(
        np.abs(xn - xn_cpu).max(axis=1) / np.abs(xn_cpu).max(axis=1)))
    out["update_rel_err_vs_cpu"] = _rel_err(w, w_cpu_same_x, 1e-30)
    out["weights_rel_err_vs_cpu"] = _rel_err(w, w_cpu, 1e-30)
    _require(out["state_row_err_vs_cpu"] <= 1e-5,
             f"predicted particles differ from the CPU run: {out}")
    _require(out["update_rel_err_vs_cpu"] <= 1e-4,
             f"weights differ from the CPU update: {out}")
    return out


def gsukf_phase(n: int, device, cpu, *, reps: int = 3, seed: int = 0) -> dict:
    x0, state_pdf, meas_pdf, u, z = sim.filter_rig()
    f = bio.Bioreactor.homeostatic_DEs
    g = bio.Bioreactor.static_outputs
    dt = jnp.float32(DT)
    state = jax.device_put(
        gs_ukf.init(jax.random.PRNGKey(seed), n, x0, state_pdf), device)
    step = jax.jit(functools.partial(
        gs_ukf.step, u=u, z=z, dt=dt, f=f, g=g, state_pdf=state_pdf,
        measurement_pdf=meas_pdf))
    compiled, last, compile_s, times = _timed_steps(step, state, reps)
    _require(bool(jnp.isfinite(last.means).all()), "non-finite bank")

    # the bank resample against the plain reference, same weights and r
    pre = jax.jit(lambda s: gs_ukf.update(
        gs_ukf.predict(s, u, dt, f, state_pdf), u, z, g, meas_pdf))(state)
    post = jax.jit(gs_ukf.resample)(pre)
    r = jax.random.uniform(jax.random.split(pre.key)[1], ())

    @jax.jit
    def reference(means, covs, w, r):
        idx = systematic_resample_indices(w, r)
        return sorted_row_gather(means, idx), sorted_row_gather(covs, idx)

    means_ref, covs_ref = reference(pre.means, pre.covariances, pre.weights, r)
    _require(np.array_equal(post.means, means_ref), "bank means differ")
    _require(np.array_equal(post.covariances, covs_ref),
             "bank covariances differ")

    est = np.asarray(gs_ukf.point_estimate(compiled(state)), np.float64)
    state_cpu = jax.device_put(jax.device_get(state), cpu)
    est_cpu = np.asarray(
        gs_ukf.point_estimate(jax.jit(step)(state_cpu)), np.float64)
    err = float(np.max(np.abs(est - est_cpu)) / np.max(np.abs(est_cpu)))
    _require(err <= 1e-3, f"point estimate differs from the CPU run: {err}")
    return {"n": n, "compile_s": compile_s,
            "median_step_ms": 1e3 * float(np.median(times)),
            "timing": "smoke timing, not a benchmark",
            "point_estimate_rel_err_vs_cpu": err}


def reference_loop(end_time: int, dt_control: int):
    """The no-noise loop driven by the float64 reference solver; returns
    ``(us, seconds)``."""
    from gpu_se_tpu.control.reference import ReferenceLayoutMPC

    t0 = time.perf_counter()
    _, lin, K, _ = sim.get_parts(dt_control=dt_control, N_particles=8, pf=True)
    k_ref = ReferenceLayoutMPC(
        P=K.P, M=K.M, Q=K.Q, R=K.R, lin=lin, ysp=K.ysp,
        u_bounds=[np.array([0, np.inf]) - lin.u_bar[0],
                  np.array([0, np.inf]) - lin.u_bar[1]],
    )
    _, us, _, _ = sim.run_no_noise_loop(
        k_ref, lin, end_time=end_time, dt_control=dt_control)
    return us, time.perf_counter() - t0


def _reference_child(conn, end_time, dt_control):
    """Child-process body: CPU only, so it never opens the card."""
    jax.config.update("jax_platforms", "cpu")
    try:
        conn.send(("ok", reference_loop(end_time, dt_control)))
    except Exception:  # noqa: BLE001 — reported to the parent, which fails
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class ReferenceProcess:
    """``reference_loop`` in a spawned CPU-only child, started early so the
    float64 host solves overlap the card's phases."""

    def __init__(self, end_time: int, dt_control: int):
        ctx = multiprocessing.get_context("spawn")
        self._conn, child_conn = ctx.Pipe(duplex=False)
        env = os.environ.copy()
        os.environ["JAX_PLATFORMS"] = "cpu"     # inherited by the child
        try:
            self._proc = ctx.Process(
                target=_reference_child, args=(child_conn, end_time, dt_control),
                daemon=True)
            self._proc.start()
        finally:
            os.environ.clear()
            os.environ.update(env)
        child_conn.close()

    def result(self, timeout: float):
        _require(self._conn.poll(timeout), "reference loop timed out")
        status, payload = self._conn.recv()
        self._proc.join(timeout=30)
        _require(status == "ok", f"reference loop failed:\n{payload}")
        return payload

    def stop(self):
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join(timeout=30)


class _IterationRecorder:
    """Passes ``step`` through to an MPC and records its QP telemetry."""

    def __init__(self, mpc):
        self.mpc = mpc
        self.iterations, self.near_solved = [], 0

    def step(self, x0, um1, y0):
        u = self.mpc.step(x0, um1, y0)
        self.iterations.append(int(self.mpc.last_solution.iterations))
        self.near_solved += int(self.mpc.near_solved)
        return u


def mpc_phase(device, reference, *, end_time: int = 10,
              dt_control: int = 1) -> dict:
    """``reference`` is ``(us_ref, seconds)`` from :func:`reference_loop`."""
    us_ref, ref_seconds = reference
    with jax.default_device(device):
        _, lin, K, _ = sim.get_parts(dt_control=dt_control, N_particles=8,
                                     pf=True)
        rec = _IterationRecorder(K)
        t0 = time.perf_counter()
        _, us, _, _ = sim.run_no_noise_loop(
            rec, lin, end_time=end_time, dt_control=dt_control)
        seconds = time.perf_counter() - t0
    err = float(np.abs(us - us_ref).max())
    _require(err <= 1e-4, f"max|u - u_ref| = {err}")
    return {"P": K.P, "M": K.M, "control_steps": len(rec.iterations),
            "max_abs_u_err": err, "admm_iterations": rec.iterations,
            "near_solved_steps": rec.near_solved,
            "loop_seconds": seconds,
            "reference_setup_seconds": ref_seconds}


def closed_loop_phase(n: int, device, *, end_time: int = 10,
                      dt_control: int = 1, dt_predict: float = DT) -> dict:
    with jax.default_device(device):
        s = sim.Simulation(N_particles=n, dt_control=dt_control,
                           dt_predict=dt_predict, end_time=end_time)
        t0 = time.perf_counter()
        s.simulate()
        seconds = time.perf_counter() - t0
    _require(np.isfinite(s.performance), f"ITSE {s.performance}")
    _require(s.mpc_frac == 1, f"mpc_frac {s.mpc_frac}")
    return {"n": n, "itse": float(s.performance), "mpc_frac": s.mpc_frac,
            "seconds": seconds}


def four_phase(devices, n: int, n_gsukf: int,
               pf_impls=("xla", "a2a_xla")) -> dict:
    """Sharded PF (the ``pf_impls`` resample protocols) and GSUKF steps
    on a mesh of ``devices`` against the same steps on a 1-device mesh:
    bitwise."""
    from gpu_se_tpu.parallel import (
        make_mesh,
        make_shard_map_gsukf_step,
        make_shard_map_step,
        shard_gsukf_state,
        shard_pf_state,
    )

    x0, state_pdf, meas_pdf, u, z = sim.filter_rig()
    f = bio.Bioreactor.homeostatic_DEs
    g = bio.Bioreactor.static_outputs
    dt = jnp.float32(DT)
    meshes = {"wide": make_mesh(devices=devices),
              "one": make_mesh(devices=devices[:1])}
    out = {"width": len(devices), "n": n, "n_gsukf": n_gsukf}
    with jax.default_device(devices[0]):
        pf_state = pf_core.init(jax.random.PRNGKey(0), n, x0)
        gs_state = gs_ukf.init(jax.random.PRNGKey(1), n_gsukf, x0, state_pdf)
    for impl in pf_impls:
        parts = {}
        for name, mesh in meshes.items():
            step = make_shard_map_step(mesh, f, g, resample_impl=impl)
            t0 = time.perf_counter()
            res = step(shard_pf_state(pf_state, mesh), u, z, dt,
                       state_pdf, meas_pdf)
            parts[name] = np.asarray(res.particles)
            out[f"pf_{impl}_{name}_first_call_s"] = time.perf_counter() - t0
        _require(np.array_equal(parts["wide"], parts["one"]),
                 f"pf {impl}: wide mesh differs from one device")
    banks = {}
    for name, mesh in meshes.items():
        step = make_shard_map_gsukf_step(mesh, f, g)
        res = step(shard_gsukf_state(gs_state, mesh), u, z, dt,
                   state_pdf, meas_pdf)
        banks[name] = (np.asarray(res.means), np.asarray(res.covariances))
    _require(np.array_equal(banks["wide"][0], banks["one"][0])
             and np.array_equal(banks["wide"][1], banks["one"][1]),
             "gsukf: wide mesh differs from one device")
    return out


# ----------------------------------------------------------------------
def run_phase(name: str, fn, *args, **kwargs) -> dict:
    t0 = time.perf_counter()
    try:
        result = fn(*args, **kwargs)
    except Exception as e:
        _emit({"phase": name, "ok": False,
               "error": f"{type(e).__name__}: {e}",
               "seconds": time.perf_counter() - t0})
        raise
    _emit({"phase": name, "ok": True,
           "seconds": time.perf_counter() - t0, **result})
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-device sharded phase")
    args = parser.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: JAX platform is {dev.platform!r}, not 'gpu'")
    enable_compile_cache()
    smi = nvidia_smi()
    info = run_phase("device", device_phase, smi)

    if args.four:
        devs = jax.devices()
        _require(len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}")
        run_phase("four", four_phase, devs[:4], n=2**22, n_gsukf=2**18)
    else:
        cpu = jax.devices("cpu")[0]
        ref = ReferenceProcess(end_time=10, dt_control=1)
        try:
            run_phase("pf", pf_phase, 2**20, dev, cpu)
            run_phase("gsukf", gsukf_phase, 2**18, dev, cpu)
            run_phase("mpc", lambda: mpc_phase(dev, ref.result(timeout=900)))
            run_phase("closed_loop", closed_loop_phase, 2**20, dev)
        finally:
            ref.stop()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)


if __name__ == "__main__":
    main()
