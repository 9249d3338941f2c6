"""Energy per GSF kernel run (twin of pf_power).

Re-creation of /root/reference/results/gsf_openloop/gsf_power.py. The
reference rescaled ``gsf.weights /= 1e3`` each update to dodge float32
underflow; the fused step here resamples every cycle (normalizing the
weights), so no rescue factor is needed.
"""
import time

import jax
import numpy as np

from gpu_se_tpu.utils import PickleJar, PowerMeasurement, RunSequences
from results._common import save_fig
from results._filter_bench import build, _leaf

N_LOG2 = np.arange(0, 17, 2.0)


@RunSequences.vectorize
@PickleJar.pickle(path="gsf/power")
@PowerMeasurement.measure
def step_energy(N, t_run, gpu):
    state, ops = build("gsf", N, gpu)
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
    return [
        (int(n), float(e[0] / c), float(e[1] / c)) for n, (c, e) in zip(ns, results)
    ]


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
            accel_missing = True
    if accel_missing:
        plt.title("accelerator probe unavailable on this rig: "
                  "accelerator energy = NaN (host-CPU energy only)",
                  fontsize=8)
    plt.xlabel("N Gaussians"); plt.ylabel("J / step"); plt.legend()
    return save_fig("gsf_power.png")


if __name__ == "__main__":
    plot()
