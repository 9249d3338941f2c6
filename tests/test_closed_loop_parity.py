"""Control-sequence parity: the condensed MPC vs the reference QP layout
over the full no-noise closed loop.

This is the BASELINE.json north-star check ("bit-tolerant control-sequence
parity"): the bioreactor plant is driven for 50 simulated minutes at
dt_control=1 twice — once by our condensed/whitened/centered MPC, once by
the reference's sparse simultaneous-form QP (transcribed from
/root/reference/controller.py and solved by an independent float64 numpy
ADMM) — and the input sequences must agree within tight tolerance, with
the small numeric differences not compounding (the loop is
bias-corrected, which keeps trajectories locked together).
"""
import os

import numpy as np
import pytest

from gpu_se_tpu import sim
from gpu_se_tpu.control.reference import ReferenceLayoutMPC
from gpu_se_tpu.sim import run_no_noise_loop
from gpu_se_tpu.utils import PickleJar


@PickleJar.pickle(
    "parity",
    # pin the committed cache: GPU_SE_PICKLEJAR_ROOT (set by the
    # experiment smokes) must not redirect this 13-minute memo
    root=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "picklejar",
    ),
)
def reference_no_noise_trajectory(dt_control, end_time):
    """Deterministic reference trajectory: the sparse simultaneous-form QP
    (controller.py layout) solved by the independent float64 ADMM, driven
    through the no-noise loop. Expensive (~minutes) and fully
    deterministic, so it is PickleJar-cached and the cache directory is
    committed — the same cached-results methodology the reference repo
    uses (/root/reference/README.md:22-38). Delete picklejar/parity/ to
    force regeneration."""
    _, lin_model, K_ours, _ = sim.get_parts(
        dt_control=dt_control, N_particles=8, pf=True
    )
    K_ref = ReferenceLayoutMPC(
        P=K_ours.P, M=K_ours.M, Q=K_ours.Q, R=K_ours.R,
        lin=lin_model, ysp=K_ours.ysp,
        u_bounds=[
            np.array([0, np.inf]) - lin_model.u_bar[0],
            np.array([0, np.inf]) - lin_model.u_bar[1],
        ],
    )
    ts, us_ref, xs_ref, ys_ref = run_no_noise_loop(
        K_ref, lin_model, end_time=end_time, dt_control=dt_control
    )
    return ts, us_ref, ys_ref


def test_no_noise_control_sequence_parity():
    """Runs at dt_control=2 (P=150, M=100); the full P=300 configuration
    is covered by results/verify_parity.py."""
    _, lin_model, K_ours, _ = sim.get_parts(dt_control=2, N_particles=8, pf=True)

    ts, us_ours, xs_ours, ys_ours = run_no_noise_loop(K_ours, lin_model, dt_control=2)
    ts, us_ref, ys_ref = reference_no_noise_trajectory(2, 50)

    # Input sequences agree to ~1e-4 L/min on inputs of order 0.01-0.2
    max_u_err = np.abs(us_ours - us_ref).max()
    assert max_u_err < 2e-4, f"max input error {max_u_err}"
    # Output trajectories agree to a fraction of a mg/L on ~300-1000 scales
    max_y_err = np.abs(ys_ours[:, [0, 2]] - ys_ref[:, [0, 2]]).max()
    assert max_y_err < 2.0, f"max output error {max_y_err}"

    # Control quality (time-weighted ISE) matches between implementations
    perf_ours = sim.performance(
        ys_ours[:, lin_model.outputs], lin_model.yd2n(K_ours.ysp), ts
    )
    perf_ref = sim.performance(
        ys_ref[:, lin_model.outputs], lin_model.yd2n(K_ours.ysp), ts
    )
    assert perf_ours == pytest.approx(perf_ref, rel=1e-3)
    # and the loop actually regulates: outputs end near the setpoint
    ysp_nat = lin_model.yd2n(K_ours.ysp)
    np.testing.assert_allclose(ys_ours[-1, [0, 2]], ysp_nat, rtol=0.05)
