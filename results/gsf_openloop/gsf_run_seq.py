"""GSF kernel run sequences + sigma-point benchmark + timer-overhead
control experiment.

Re-creation of /root/reference/results/gsf_openloop/gsf_run_seq.py
(including the no-op/time.time() benchmark-methodology control at
:396-470).
"""
import time

import numpy as np

from gpu_se_tpu.utils import PickleJar, RunSequences, max_abs_pacf
from results._common import save_fig
from results._filter_bench import build, device_kind, run_seq, time_op

CPU_LOG2 = np.arange(0, 15, 1.0)
# the full reference accelerator grid, 2^0..2^18.5 in half-log2 steps
# (reference gsf_run_seq.py:483-497)
ACC_LOG2 = np.arange(0, 19, 0.5)


@PickleJar.pickle(path="gsf/raw")
def gsf_op_run_seq(op, N, runs, gpu, device_kind):
    """One memoized run sequence. ``device_kind`` is part of the memo key
    only, so a result measured on one device is never served for another."""
    del device_kind
    return run_seq("gsf", op, N, runs, gpu)


@RunSequences.vectorize
def predict_run_seq(N, runs, gpu):
    return gsf_op_run_seq("predict", N, runs, gpu, device_kind(gpu))


@RunSequences.vectorize
def update_run_seq(N, runs, gpu):
    return gsf_op_run_seq("update", N, runs, gpu, device_kind(gpu))


@RunSequences.vectorize
def resample_run_seq(N, runs, gpu):
    return gsf_op_run_seq("resample", N, runs, gpu, device_kind(gpu))


@RunSequences.vectorize
def sigma_points_run_seq(N, runs, gpu):
    return sigma_points_memo(N, runs, gpu, device_kind(gpu))


@PickleJar.pickle(path="gsf/raw")
def sigma_points_memo(N, runs, gpu, device_kind):
    """Sigma-point generation alone (batched Cholesky + spread,
    cf. gsf_run_seq.py:139-173 in the reference); ``device_kind`` keys
    the memo."""
    import jax

    from gpu_se_tpu.filters import gs_ukf

    state, _ = build("gsf", N, gpu)
    # chain through the state (first sigma point == mean) so successive
    # calls see fresh inputs and nothing is cache-served
    sp = jax.jit(lambda s: s.replace(means=gs_ukf.get_sigma_points(s)[:, 0, :]))
    return time_op(sp, state, runs)


@RunSequences.vectorize
@PickleJar.pickle(path="gsf/noop")
def noop_run_seq(N, runs, gpu):
    """Timer-overhead control: time an empty region
    (cf. gsf_run_seq.py:396-470)."""
    del N, gpu
    out = np.empty(runs)
    for i in range(runs):
        t0 = time.perf_counter()
        out[i] = time.perf_counter() - t0
    return out


def cpu_gpu_run_seqs(runs=50):
    out = []
    for gpu, log2s in ((False, CPU_LOG2), (True, ACC_LOG2)):
        ns = (2.0**log2s).astype(int)
        out.append(
            [
                predict_run_seq(ns, runs, gpu),
                update_run_seq(ns, runs, gpu),
                resample_run_seq(ns, runs, gpu),
            ]
        )
    return out


def plot(runs=50):
    import matplotlib.pyplot as plt

    (cpu_seqs, acc_seqs) = cpu_gpu_run_seqs(runs)
    names = ["predict", "update", "resample"]
    fig, axes = plt.subplots(1, 3, sharey="row", figsize=(18, 5))
    for ax, name, cpu_rs, acc_rs in zip(axes, names, cpu_seqs, acc_seqs):
        for label, (ns, seqs) in (("CPU", cpu_rs), ("accelerator", acc_rs)):
            med = np.median(seqs, axis=1)
            ax.loglog(ns, med, ".-", label=label)
            ax.fill_between(
                ns, np.quantile(seqs, 0.1, axis=1), np.quantile(seqs, 0.9, axis=1),
                alpha=0.2,
            )
        ax.set_title(name); ax.set_xlabel("N Gaussians"); ax.legend()
    axes[0].set_ylabel("time per call (s)")
    save_fig("gsf_run_seq.png")

    plt.figure(figsize=(6.25, 5))
    for name, cpu_rs, acc_rs in zip(names, cpu_seqs, acc_seqs):
        ns_c, seq_c = cpu_rs
        ns_a, seq_a = acc_rs
        k = min(len(ns_c), len(ns_a))
        plt.loglog(
            ns_c[:k],
            np.median(seq_c, axis=1)[:k] / np.median(seq_a, axis=1)[:k],
            ".-", label=name,
        )
    plt.axhline(1.0, color="red", alpha=0.5)
    plt.xlabel("N Gaussians"); plt.ylabel("CPU / accelerator"); plt.legend()
    return save_fig("gsf_speedup.png")


if __name__ == "__main__":
    plot()
