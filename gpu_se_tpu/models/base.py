"""Nonlinear process-model interface.

Mirrors the reference ABC surface (``DEs``/``step``/``outputs``,
/root/reference/model/NonlinearModel.py:1-29) and adds the pure-function
hooks (``des``/``out``) that make a model usable inside JAX transforms
(``jit``/``vmap``/``jacfwd``) — the JAX replacement for the
reference's "static method so numba can compile it" pattern
(/root/reference/model/BioreactorModel.py:170-253).
"""
from __future__ import annotations

import abc

import numpy as np


class NonlinearModel(abc.ABC):
    """Stateful shell for host-side plant simulation.

    Attributes
    ----------
    X : numpy.ndarray
        Current state (mutated by :meth:`step`).
    t : float
        Current time.
    """

    X: np.ndarray
    t: float

    @abc.abstractmethod
    def DEs(self, inputs):
        """Time derivatives of the state at the current state and inputs."""

    def step(self, dt, inputs):
        """Explicit-Euler update of the internal state."""
        self.t += dt
        dX = self.DEs(inputs)
        self.X = self.X + np.asarray(dX) * dt
        return self.outputs(inputs)

    @abc.abstractmethod
    def outputs(self, inputs):
        """Model outputs at the current state."""

    # ------------------------------------------------------------------
    # Pure-function hooks for JAX transforms. Implementations must be
    # side-effect-free functions of (x, u) built from jax.numpy ops.
    # ------------------------------------------------------------------
    def des(self, x, u):
        """Pure state-derivative function dx/dt = des(x, u)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a pure `des(x, u)`; "
            "the linearizer will fall back to finite differences."
        )

    def out(self, x, u):
        """Pure output function y = out(x, u)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose a pure `out(x, u)`."
        )
