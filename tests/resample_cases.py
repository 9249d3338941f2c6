"""Particle counts and weight regimes shared by the resample tests."""
import numpy as np

NS = (4096, 5000, 2**16)
NXS = (2, 5, 7)
REGIMES = ("uniform", "heavy_tailed", "one_hot", "underflow")


def regime_weights(regime: str, n: int, seed: int = 0) -> np.ndarray:
    """(n,) float32 weights of one regime: equal weights, lognormal heavy
    tails, a single surviving particle, or an underflowed likelihood —
    most weights exactly zero, the rest near the bottom of the normal
    float32 range."""
    rng = np.random.default_rng(seed)
    if regime == "uniform":
        return np.full(n, 1.0 / n, np.float32)
    if regime == "heavy_tailed":
        return np.exp(6.0 * rng.standard_normal(n)).astype(np.float32)
    if regime == "one_hot":
        w = np.zeros(n, np.float32)
        w[rng.integers(n)] = 1.0
        return w
    if regime == "underflow":
        w = np.exp(-80.0 + 1.5 * rng.standard_normal(n)).astype(np.float32)
        return np.where(rng.random(n) < 0.8, 0.0, w).astype(np.float32)
    raise ValueError(regime)
