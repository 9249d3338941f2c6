"""PowerMeasurement — energy-per-run instrumentation.

Re-creation of /root/reference/decorators.py:94-206: a background thread
samples CPU utilization (psutil) and accelerator power at 5 Hz and the
readings are trapezoid-integrated into J/run. Accelerator probes are
tried in order — ``nvidia-smi`` for the GPU in use, then a sysfs hwmon
counter (which on a GPU host may be a board or CPU sensor, hence last).

The sampler is a thread, not a forked process: a fork after JAX has
opened the device would duplicate a process that holds the card.

HONESTY CONTRACT: when no accelerator probe works the accelerator energy
is reported as ``NaN`` — never a silent 0 J that downstream plots would
present as data. ``accelerator_probe_available()`` lets callers annotate
plots/tables with the missing-probe condition.
"""
from __future__ import annotations

import glob
import os
import subprocess
import threading
import time

import numpy as np
import psutil
import scipy.integrate


def _gpu_index() -> str:
    """The GPU this process uses: the first visible device."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    return visible.split(",")[0].strip() or "0"


def _read_nvidia_smi():
    try:
        out = subprocess.check_output(
            ["nvidia-smi", f"--id={_gpu_index()}",
             "--query-gpu=power.draw", "--format=csv,noheader,nounits"],
            stderr=subprocess.DEVNULL,
            timeout=2,
        )
        return float(out)
    except (OSError, ValueError, subprocess.SubprocessError):
        return None


def _read_sysfs_power():
    """Best-effort power (W) from sysfs hwmon counters."""
    for path in glob.glob("/sys/class/hwmon/hwmon*/power1_input"):
        try:
            with open(path) as fh:
                return float(fh.read()) / 1e6  # microwatts -> watts
        except (OSError, ValueError):
            continue
    return None


def get_accelerator_power():
    """Current accelerator power draw in watts, or ``None`` when no probe
    works (recorded as NaN by the sampler — never a silent 0)."""
    for probe in (_read_nvidia_smi, _read_sysfs_power):
        val = probe()
        if val is not None:
            return val
    return None


def accelerator_probe_available() -> bool:
    """True iff some accelerator power probe returns readings here."""
    return get_accelerator_power() is not None


def get_cpu_frac():
    return psutil.cpu_percent() / 100.0


def _power_seq(stop: threading.Event, out: list):
    """Sampler loop run in a background thread (cf.
    /root/reference/decorators.py:188-206)."""
    times, cpu_frac, accel_power = [], [], []
    while not stop.is_set():
        times.append(time.time())
        cpu_frac.append(get_cpu_frac())
        watts = get_accelerator_power()
        accel_power.append(np.nan if watts is None else watts)
        stop.wait(0.2)
    out.append(np.array([times, cpu_frac, accel_power]))


class PowerMeasurement:
    """Wrap ``f(N, t_run, ...)``; returns ``(result, [E_cpu, E_accel])``
    in joules."""

    def __init__(self, function, CPU_max_power=30.0):
        self.function = function
        self.CPU_max_power = CPU_max_power
        self.__name__ = getattr(function, "__name__", "power_measured")
        self.__code__ = getattr(function, "__code__", None)

    def __call__(self, N_particle, t_run, *args, **kwargs):
        stop, out = threading.Event(), []
        sampler = threading.Thread(target=_power_seq, args=(stop, out),
                                   daemon=True)
        sampler.start()
        try:
            res = self.function(N_particle, t_run, *args, **kwargs)
        finally:
            stop.set()
            sampler.join()
        power_seq = out[0]
        energy = scipy.integrate.trapezoid(power_seq[1:, :], power_seq[0], axis=1)
        energy[0] *= self.CPU_max_power
        return res, energy

    @staticmethod
    def measure(function, *args, **kwargs):
        return PowerMeasurement(function, *args, **kwargs)
