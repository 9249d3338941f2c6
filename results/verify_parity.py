"""Full-scale control-sequence parity verification (BASELINE north star).

Runs the no-noise closed loop at the canonical configuration
(dt_control=1, P=300, M=200) twice — the condensed float32 MPC vs the
reference sparse-layout QP solved by an independent float64 ADMM — and
reports the max-abs input/output deviations. The scaled-down version of
this check runs in the test suite (tests/test_closed_loop_parity.py).

Usage: python results/verify_parity.py [end_time]
"""
import sys

import numpy as np

from results._common import _REPO  # noqa: F401  (sys.path setup)
from gpu_se_tpu import sim
from gpu_se_tpu.control.reference import ReferenceLayoutMPC
from gpu_se_tpu.sim import run_no_noise_loop


def main(end_time=50):
    _, lin_model, K_ours, _ = sim.get_parts(dt_control=1, N_particles=8, pf=True)
    K_ref = ReferenceLayoutMPC(
        P=K_ours.P, M=K_ours.M, Q=K_ours.Q, R=K_ours.R,
        lin=lin_model, ysp=K_ours.ysp,
        u_bounds=[
            np.array([0, np.inf]) - lin_model.u_bar[0],
            np.array([0, np.inf]) - lin_model.u_bar[1],
        ],
    )
    ts, us_ours, _, ys_ours = run_no_noise_loop(K_ours, lin_model, end_time=end_time)
    ts, us_ref, _, ys_ref = run_no_noise_loop(K_ref, lin_model, end_time=end_time)

    print("max |u_ours - u_ref|:", np.abs(us_ours - us_ref).max())
    print("max |y_ours - y_ref|:", np.abs(ys_ours[:, [0, 2]] - ys_ref[:, [0, 2]]).max())
    perf_ours = sim.performance(ys_ours[:, lin_model.outputs],
                                lin_model.yd2n(K_ours.ysp), ts)
    perf_ref = sim.performance(ys_ref[:, lin_model.outputs],
                               lin_model.yd2n(K_ours.ysp), ts)
    print("ITSE ours:", perf_ours, " ITSE ref:", perf_ref)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 50)
