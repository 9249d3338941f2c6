"""Mesh construction helpers for particle-axis data parallelism."""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

PARTICLE_AXIS = "particles"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              axis_name: str = PARTICLE_AXIS) -> Mesh:
    """1-D device mesh over the particle axis.

    The reference's one real parallel axis is the particle/sigma-bank
    axis (SURVEY.md section 2.4); a 1-D mesh over it is the whole
    distribution story. The devices of one GPU host reach each other
    all to all, so the mesh follows the algorithm, not a topology.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def particle_sharding(mesh: Mesh, axis_name: str = PARTICLE_AXIS) -> NamedSharding:
    """Shard the leading (particle) axis; replicate everything else."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
