"""Multi-process initialization for runs that span several hosts.

The reference is single-process/single-GPU (SURVEY.md section 2.4); the
framework's multi-process story is ``jax.distributed.initialize`` + the
same 1-D particle mesh spanning every device of every process: XLA
inserts the collectives from the very same ``shard_map``/GSPMD code that
the tests exercise on the virtual CPU mesh.
"""
from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
):
    """Initialize multi-host JAX if the environment calls for it.

    No-ops on single-process runs (the common case in tests and on one
    host). Otherwise pass the coordinator address (``host:port``), the
    process count and this process's id, or set the coordinator address
    in the environment for a cluster manager JAX detects.
    """
    env_says_multi = any(
        os.environ.get(k)
        for k in ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")
    )
    if coordinator_address is None and num_processes is None and not env_says_multi:
        # single-process: nothing to do
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(axis_name: str = "particles"):
    """1-D mesh over every device in the (possibly multi-host) job."""
    from gpu_se_tpu.parallel.mesh import make_mesh

    return make_mesh(devices=jax.devices(), axis_name=axis_name)
