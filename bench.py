"""Headline benchmark: fused particle-filter step throughput at 2^20
particles on one accelerator.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "device": {...}}

vs_baseline is the speedup over the regenerated CPU reference number in
bench_baseline.json (the reference repo publishes no absolute numbers;
see BASELINE.md). The full step = predict (bioreactor dynamics + mixture
noise) + update (measurement pdf weighting) + systematic resample of the
structure-of-arrays state (filters/particle_tiled.py), fused in a single
jit — the hot op of the closed-loop rig
(cf. /root/reference/results/pf_openloop/pf_run_seq.py).

The step time is the mean over a chained loop of REPS steps with one
final ``block_until_ready``; compilation and one warm-up step come
first. Refuses to run without an accelerator: a CPU number is not this
benchmark's metric.

Run on the card: ``python bench.py``.
"""
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gpu_se_tpu.config import REPO_ROOT, enable_compile_cache  # noqa: E402
from gpu_se_tpu.filters import particle_tiled as pft  # noqa: E402
from gpu_se_tpu.models import bioreactor as bio  # noqa: E402
from gpu_se_tpu.sim import filter_rig  # noqa: E402

N = 2**20
REPS = 30


def main():
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("bench.py: JAX found no accelerator")
    enable_compile_cache()
    x0, state_pdf, meas_pdf, u, z = filter_rig()
    f = functools.partial(bio.homeostatic_des, xp=jnp)
    g = functools.partial(bio.static_outputs, xp=jnp)

    seed = int(time.time() * 1000) % (2**31)
    state = pft.init(jax.random.PRNGKey(seed), N, x0)

    @jax.jit
    def step(state):
        return pft.step(
            state, u, z, jnp.float32(0.1), f, g, state_pdf, meas_pdf
        )

    # compile + warmup
    state = step(state)
    jax.block_until_ready(state.x)

    t0 = time.perf_counter()
    for _ in range(REPS):
        state = step(state)
    jax.block_until_ready(state.x)
    steps_per_s = REPS / (time.perf_counter() - t0)

    with open(os.path.join(REPO_ROOT, "bench_baseline.json")) as fh:
        baseline = json.load(fh)["pf_step_2e20_cpu_steps_per_s"]

    print(
        json.dumps(
            {
                "metric": "pf_full_step_throughput_2^20_particles",
                "value": steps_per_s,
                "unit": "steps/s",
                "vs_baseline": steps_per_s / baseline,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
