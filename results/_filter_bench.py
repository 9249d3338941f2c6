"""Shared filter-benchmark machinery for the run-sequence experiments.

Builds the canonical-rig filter at a given particle count on a chosen
backend (accelerator or host CPU — same code, different device, replacing
the reference's twin-class split), then times predict / update / resample
/ full-step with chained inputs so nothing is served from caches.
Methodology follows /root/reference/results/pf_openloop/pf_run_seq.py:
wall-clock run sequences, medians with quantile bars, pacf validity gate.
"""
from __future__ import annotations

import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from gpu_se_tpu.filters import gs_ukf, particle as pf_core
from gpu_se_tpu.models import bioreactor as bio
from gpu_se_tpu.sim import filter_rig


def get_device(gpu: bool):
    """gpu=True -> default accelerator; gpu=False -> host CPU backend.

    Raises when an accelerator leg finds only a CPU: its timings would
    be CPU data under an accelerator label."""
    if gpu:
        dev = jax.devices()[0]
        if dev.platform == "cpu":
            raise RuntimeError(
                "accelerator leg requested but JAX found only a CPU")
        return dev
    return jax.devices("cpu")[0]


def device_kind(gpu: bool) -> str:
    """``device_kind`` of the device a leg runs on (a memo key)."""
    return get_device(gpu).device_kind


def build(kind: str, n: int, gpu: bool):
    """Return (state, ops) for ``kind`` in {'pf', 'gsf'} on the device."""
    x0, state_pdf, meas_pdf, u, z = filter_rig()
    f = bio.Bioreactor.homeostatic_DEs
    g = bio.Bioreactor.static_outputs
    dev = get_device(gpu)
    core = pf_core if kind == "pf" else gs_ukf

    with jax.default_device(dev):
        if kind == "pf":
            state = pf_core.init(jax.random.PRNGKey(0), n, x0)
        else:
            state = gs_ukf.init(jax.random.PRNGKey(0), n, x0, state_pdf)
        state = jax.device_put(state, dev)
        ops = dict(
            predict=jax.jit(
                lambda s: core.predict(s, u, jnp.float32(0.1), f, state_pdf),
                device=dev,
            ),
            update=jax.jit(lambda s: core.update(s, u, z, g, meas_pdf), device=dev),
            resample=jax.jit(core.resample, device=dev),
            step=jax.jit(
                lambda s: core.step(s, u, z, jnp.float32(0.1), f, g, state_pdf, meas_pdf),
                device=dev,
            ),
        )
    return state, ops


def _leaf(s):
    return jax.tree_util.tree_leaves(s)[0]


def time_op(op, state, runs: int, chunk: int = 5) -> np.ndarray:
    """Chained wall-clock run sequence.

    Chaining state through the op makes every call see fresh inputs.
    Calls are timed in chunks of ``chunk`` with one ``block_until_ready``
    per chunk, amortizing the host sync the way production closed loops
    do. Each run's recorded time is its chunk mean.
    """
    s = op(state)
    jax.block_until_ready(_leaf(s))
    out = np.empty(runs)
    done = 0
    while done < runs:
        c = min(chunk, runs - done)
        t0 = time.perf_counter()
        for _ in range(c):
            s = op(s)
        jax.block_until_ready(_leaf(s))
        out[done:done + c] = (time.perf_counter() - t0) / c
        done += c
    return out


def run_seq(kind: str, op_name: str, n: int, runs: int, gpu: bool) -> np.ndarray:
    state, ops = build(kind, n, gpu)
    return time_op(ops[op_name], state, runs)


def breakdown_pf(n: int, runs: int, gpu: bool):
    """Per-stage timings of the PF cycle (cf. the sub-routine fraction
    stack plots, /root/reference/results/pf_openloop/pf_run_seq.py:517-554):
    predict split into dynamics vs noise draw; resample split into
    cumsum+indices vs gather."""
    import jax
    from gpu_se_tpu.filters.resampling import systematic_resample_indices

    _, state_pdf, _, u, _ = filter_rig()
    f = bio.Bioreactor.homeostatic_DEs
    dev = get_device(gpu)
    state, ops = build("pf", n, gpu)

    with jax.default_device(dev):
        dyn = jax.jit(
            lambda s: s.replace(
                particles=s.particles
                + jax.vmap(f, in_axes=(0, None, None))(s.particles, u, jnp.float32(0.1))
            ),
            device=dev,
        )

        def noise_only(s):
            key, sub = jax.random.split(s.key)
            return s.replace(particles=s.particles + state_pdf.draw(sub, (n,)), key=key)

        noi = jax.jit(noise_only, device=dev)

        def indices_only(s):
            key, sub = jax.random.split(s.key)
            r = jax.random.uniform(sub, ())
            idx = systematic_resample_indices(s.weights + 1e-12, r)
            # fold indices back into weights (scaled tiny, NOT *0 which
            # XLA would dead-code-eliminate) so calls chain un-cached
            return s.replace(
                weights=s.weights + idx.astype(s.weights.dtype) * 1e-30 + 1e-12,
                key=key,
            )

        idxf = jax.jit(indices_only, device=dev)

        def gather_only(s):
            key, sub = jax.random.split(s.key)
            shift = jax.random.randint(sub, (), 0, n)
            idx = (jnp.arange(n, dtype=jnp.int32) + shift) % n
            return s.replace(particles=jnp.take(s.particles, idx, axis=0), key=key)

        gat = jax.jit(gather_only, device=dev)

    return {
        "dynamics": time_op(dyn, state, runs),
        "noise": time_op(noi, state, runs),
        "indices": time_op(idxf, state, runs),
        "gather": time_op(gat, state, runs),
        "full_step": time_op(ops["step"], state, runs),
    }
