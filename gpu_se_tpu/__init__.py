"""gpu_se_tpu — an accelerator state-estimation and MPC framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``AlgorithmicAmoeba/gpu_se`` (GPU-accelerated state estimators for a
bioreactor process): nonlinear process models, a linear MPC built on a
dense condensed QP solved by a JAX-native ADMM solver, and two
accelerated state estimators — a particle filter and a Gaussian-sum
unscented Kalman filter — plus a closed-loop simulation harness,
instrumentation, and a benchmarking methodology.

Design stance (a redesign, not a port):

* One functional core instead of CPU/GPU twin classes: every filter is a
  pure function over an explicit state pytree; ``jit``/``vmap`` give the
  batched accelerator path and the same code runs on CPU for reference
  checks (the reference needed two implementations per filter;
  cf. /root/reference/filter/particle.py:9,117).
* Explicit ``jax.random`` keys subsume the reference's
  ``DeterministicGaussianSum`` replay fixture: same key => same draws on
  any backend (cf. /root/reference/gaussian_sum_dist/DeterministicGaussianSum.py:27).
* The OSQP sparse QP (cf. /root/reference/controller.py:231-236) becomes a
  condensed **dense** QP solved by matmul-driven ADMM — fixed
  structure at trace time, only ``q``/``l``/``u`` change per step.
* The hand-written CUDA resampling kernel
  (cf. /root/reference/filter/particle.py:223-263) becomes a vectorized
  systematic resample (cumsum -> integer segment ends -> ancestors ->
  sorted gather) with a ``shard_map`` multi-device path (segmented scan
  + exchange of the ends blocks).
"""

__version__ = "0.1.0"

from gpu_se_tpu.distributions import GaussianSum, MultivariateGaussianSum, DeterministicGaussianSum

__all__ = [
    "GaussianSum",
    "MultivariateGaussianSum",
    "DeterministicGaussianSum",
]
