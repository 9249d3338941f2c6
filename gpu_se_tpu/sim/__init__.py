from gpu_se_tpu.sim.harness import (
    Simulation,
    filter_rig,
    get_noise,
    get_parts,
    get_random_io,
    performance,
    run_no_noise_loop,
)

__all__ = ["Simulation", "filter_rig", "get_parts", "get_noise", "get_random_io", "performance",
           "run_no_noise_loop"]
