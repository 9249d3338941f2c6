"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusals.

The phases take their sizes and devices as arguments, so the whole
control flow and every comparison runs here; only the sizes and the
Triton kernel (which has no CPU lowering) are the card's.
"""
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cpu():
    return jax.devices("cpu")[0]


def test_device_phase_reports_platform():
    out = chip_smoke.device_phase("card, 700 W", platform="cpu")
    assert out["platform"] == "cpu" and out["count"] == len(jax.devices())
    assert out["nvidia_smi"] == "card, 700 W"
    with pytest.raises(chip_smoke.SmokeFailure, match="platform"):
        chip_smoke.device_phase("card, 700 W", platform="gpu")


@pytest.mark.parametrize("n", (4096, 5000))
def test_pf_phase_tiny(cpu, n):
    out = chip_smoke.pf_phase(n, cpu, cpu, kernels=("xla",), reps=2)
    assert out["n"] == n and out["nx"] == 5
    assert out["weights_rel_err_vs_cpu"] == 0.0
    assert out["update_rel_err_vs_cpu"] == 0.0
    assert out["state_row_err_vs_cpu"] == 0.0
    assert out["xla"]["median_step_ms"] > 0


def test_gsukf_phase_tiny(cpu):
    out = chip_smoke.gsukf_phase(256, cpu, cpu, reps=1)
    assert out["point_estimate_rel_err_vs_cpu"] == 0.0


def test_mpc_phase_tiny(cpu):
    """A short horizon (dt_control = 10: P = 30, M = 20) against the
    float64 reference loop run in this process."""
    ref = chip_smoke.reference_loop(end_time=30, dt_control=10)
    out = chip_smoke.mpc_phase(cpu, ref, end_time=30, dt_control=10)
    assert out["P"] == 30 and out["control_steps"] == 3
    assert out["max_abs_u_err"] <= 1e-4
    assert len(out["admm_iterations"]) == 3


def test_mpc_phase_flags_mismatch(cpu):
    us, seconds = chip_smoke.reference_loop(end_time=20, dt_control=10)
    with pytest.raises(chip_smoke.SmokeFailure, match="u_ref"):
        chip_smoke.mpc_phase(cpu, (us + 1e-3, seconds), end_time=20,
                             dt_control=10)


def test_closed_loop_phase_tiny(cpu):
    out = chip_smoke.closed_loop_phase(64, cpu, end_time=3)
    assert np.isfinite(out["itse"]) and out["mpc_frac"] == 1


def test_four_phase_on_cpu_mesh():
    """The --four path on 4 virtual CPU devices, with the ring-emulated
    a2a exchange (ragged all-to-all has no CPU lowering)."""
    out = chip_smoke.four_phase(jax.devices()[:4], n=4 * 1024, n_gsukf=4 * 64,
                                pf_impls=("xla", "a2a_ring"))
    assert out["width"] == 4


def test_main_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)


def test_alone_it_fails_without_output(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo it exits non-zero and prints nothing on stdout."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
