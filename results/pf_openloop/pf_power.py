"""Energy per PF kernel run, CPU vs accelerator.

Re-creation of /root/reference/results/pf_openloop/pf_power.py: run each
kernel for ~t_run seconds under the background power sampler and report
J/run.
"""
import time

import jax
import numpy as np

from gpu_se_tpu.utils import PickleJar, PowerMeasurement, RunSequences
from results._common import save_fig
from results._filter_bench import build, _leaf

N_LOG2 = np.arange(0, 21, 2.0)


@RunSequences.vectorize
@PickleJar.pickle(path="pf/power")
@PowerMeasurement.measure
def step_energy(N, t_run, gpu):
    """Runs fused PF steps for ``t_run`` seconds; returns run count
    (cf. pf_power.py:9-12 decorator stack in the reference)."""
    state, ops = build("pf", N, gpu)
    op = ops["step"]
    s = op(state)
    jax.block_until_ready(_leaf(s))
    t_end = time.time() + t_run
    count = 0
    # pace the dispatches: an unpaced loop enqueues ~75k async steps in
    # the window (dispatch ~0.04 ms) and then drains for MINUTES after
    while time.time() < t_end:
        for _ in range(5):
            s = op(s)
        count += 5
        jax.block_until_ready(_leaf(s))
    return count


def energy_per_run(t_run=5.0, gpu=True, log2s=N_LOG2):
    ns = (2.0**log2s).astype(int)
    _, results = step_energy(ns, t_run, gpu)
    rows = []
    for n, (count, energy) in zip(ns, results):
        rows.append((int(n), float(energy[0] / count), float(energy[1] / count)))
    return rows


def plot(t_run=5.0):
    import matplotlib.pyplot as plt

    accel_missing = False
    for gpu, label in ((True, "accelerator"), (False, "CPU")):
        rows = energy_per_run(t_run, gpu)
        ns = [r[0] for r in rows]
        host = [r[1] for r in rows]
        accel = [r[2] for r in rows]
        plt.loglog(ns, host, ".-", label=f"{label} host-CPU energy")
        if np.isfinite(accel).all():
            plt.loglog(ns, np.add(host, accel), ".--",
                       label=f"{label} host+accelerator")
        elif gpu:
            # honest missing-probe contract (gpu_se_tpu/utils/power.py):
            # NaN, never a silent 0 J pretending to be a measurement
            accel_missing = True
    if accel_missing:
        plt.title("accelerator probe unavailable on this rig: "
                  "accelerator energy = NaN (host-CPU energy only)",
                  fontsize=8)
    plt.xlabel("N particles"); plt.ylabel("J / step"); plt.legend()
    return save_fig("pf_power.png")


if __name__ == "__main__":
    plot()
