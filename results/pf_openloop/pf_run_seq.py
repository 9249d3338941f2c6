"""PF kernel run sequences: predict/update/resample times vs particle
count, CPU vs accelerator, with the pacf validity gate and speed-up plot.

Re-creation of /root/reference/results/pf_openloop/pf_run_seq.py (561
lines of CUDA-era methodology distilled onto the single JAX code path:
"CPU" = the same jit on the host backend, "GPU" = the accelerator).
"""
import numpy as np

from gpu_se_tpu.utils import PickleJar, RunSequences, max_abs_pacf
from results._common import save_fig
from results._filter_bench import device_kind, run_seq

# N ranges per backend (cf. pf_run_seq.py:337-338 in the reference;
# trimmed CPU tail — the host here is a 2-vCPU container, and integer
# log2 steps halve an already-hour-scale host campaign)
CPU_LOG2 = np.arange(1, 20, 1.0)
# the full reference accelerator grid, 2^1..2^23.5 in half-log2 steps
# (reference pf_run_seq.py:338)
ACC_LOG2 = np.arange(1, 24, 0.5)


@PickleJar.pickle(path="pf/raw")
def pf_op_run_seq(op, N, runs, gpu, device_kind):
    """One memoized run sequence. ``device_kind`` is part of the memo key
    only, so a result measured on one device is never served for another."""
    del device_kind
    return run_seq("pf", op, N, runs, gpu)


@RunSequences.vectorize
def predict_run_seq(N, runs, gpu):
    return pf_op_run_seq("predict", N, runs, gpu, device_kind(gpu))


@RunSequences.vectorize
def update_run_seq(N, runs, gpu):
    return pf_op_run_seq("update", N, runs, gpu, device_kind(gpu))


@RunSequences.vectorize
def resample_run_seq(N, runs, gpu):
    return pf_op_run_seq("resample", N, runs, gpu, device_kind(gpu))


@RunSequences.vectorize
def step_run_seq(N, runs, gpu):
    return pf_op_run_seq("step", N, runs, gpu, device_kind(gpu))


def cpu_gpu_run_seqs(runs=50):
    """All (backend, op) run sequences
    (cf. pf_run_seq.py:328-351 in the reference)."""
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


def pacf_gate(runs=50):
    """max |pacf| per run sequence; the reference's validity threshold is
    0.2 (cf. pf_run_seq.py:373-413)."""
    rows = []
    for (ns, seqs), name in zip(
        [predict_run_seq((2.0**ACC_LOG2).astype(int), runs, True)], ["predict"]
    ):
        for n, seq in zip(ns, seqs):
            rows.append((name, int(n), max_abs_pacf(seq)))
    return rows


def plot(runs=50):
    import matplotlib.pyplot as plt

    (cpu_seqs, acc_seqs) = cpu_gpu_run_seqs(runs)
    names = ["predict", "update", "resample"]
    fig, axes = plt.subplots(1, 3, sharey="row", figsize=(18, 5))
    for ax, name, cpu_rs, acc_rs in zip(axes, names, cpu_seqs, acc_seqs):
        for label, (ns, seqs) in (("CPU", cpu_rs), ("accelerator", acc_rs)):
            med = np.median(seqs, axis=1)
            lo = np.quantile(seqs, 0.1, axis=1)
            hi = np.quantile(seqs, 0.9, axis=1)
            ax.loglog(ns, med, ".-", label=label)
            ax.fill_between(ns, lo, hi, alpha=0.2)
        ax.set_title(name)
        ax.set_xlabel("N particles")
        ax.legend()
    axes[0].set_ylabel("time per call (s)")
    save_fig("pf_run_seq.png")

    # speed-up plot (cf. pf_run_seq.py:416-452)
    plt.figure(figsize=(6.25, 5))
    for name, cpu_rs, acc_rs in zip(names, cpu_seqs, acc_seqs):
        ns_c, seq_c = cpu_rs
        ns_a, seq_a = acc_rs
        k = min(len(ns_c), len(ns_a))
        plt.loglog(
            ns_c[:k],
            np.median(seq_c, axis=1)[:k] / np.median(seq_a, axis=1)[:k],
            ".-",
            label=name,
        )
    plt.axhline(1.0, color="red", alpha=0.5)
    plt.xlabel("N particles"); plt.ylabel("CPU time / accelerator time"); plt.legend()
    return save_fig("pf_speedup.png")


if __name__ == "__main__":
    plot()


def plot_breakdown(n=2**18, runs=30):
    """Stacked per-stage time attribution (reference pf_run_seq.py:517-554)."""
    import matplotlib.pyplot as plt

    from results._filter_bench import breakdown_pf

    rows = {}
    for gpu, label in ((True, "accelerator"), (False, "CPU")):
        rows[label] = {k: float(np.median(v)) for k, v in breakdown_pf(n, runs, gpu).items()}
        print(label, rows[label])
    stages = ["dynamics", "noise", "indices", "gather"]
    fig, ax = plt.subplots(figsize=(6.25, 5))
    for i, label in enumerate(rows):
        bottom = 0.0
        for st in stages:
            ax.bar(i, rows[label][st], bottom=bottom, label=st if i == 0 else None)
            bottom += rows[label][st]
    ax.set_xticks(range(len(rows)), list(rows))
    ax.set_ylabel("median time per stage (s)")
    ax.legend()
    return save_fig("pf_breakdown.png")
