"""Configuration layer — explicit dataclasses for rig construction.

The reference has no config system: positional args + two booleans in
``get_parts`` and hard-coded constants per script (SURVEY.md section 5).
These dataclasses name every knob (mesh shape, dtype, particle counts,
horizons, noise) so experiments and deployments are reproducible from a
single object.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class FilterConfig:
    kind: str = "pf"  # "pf" | "gsf"
    n_particles: int = 2**15
    seed: int = 0
    dtype: jnp.dtype = jnp.float32


@dataclasses.dataclass
class MPCConfig:
    dt_control: float = 1.0
    horizon_minutes: float = 300.0  # P = horizon // dt_control
    control_minutes: float = 200.0  # M = max(control // dt_control, 1)
    q_diag: Tuple[float, float] = (0.1, 1.0)
    r_diag: Tuple[float, float] = (1.0, 1.0)
    ysp: Tuple[float, float] = (280.0, 850.0)
    eps_abs: float = 1e-6
    eps_rel: float = 1e-6
    max_iter: int = 10000

    @property
    def P(self) -> int:
        return int(self.horizon_minutes // self.dt_control)

    @property
    def M(self) -> int:
        return max(int(self.control_minutes // self.dt_control), 1)


@dataclasses.dataclass
class MeshConfig:
    n_devices: Optional[int] = None  # None = all
    axis_name: str = "particles"


@dataclasses.dataclass
class SimConfig:
    end_time: float = 50.0
    dt_predict: float = 0.1
    filter: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


def build_rig(cfg: SimConfig):
    """Construct (bioreactor, lin_model, mpc, filter) from a config."""
    from gpu_se_tpu import sim

    return sim.get_parts(
        dt_control=cfg.mpc.dt_control,
        N_particles=cfg.filter.n_particles,
        pf=(cfg.filter.kind == "pf"),
        seed=cfg.filter.seed,
    )


REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no directory is set here. Otherwise the cache goes to the fixed path
    ``<repo>/.jax_cache`` — fixed because the path is part of the cache
    key. Entries are kept whatever their size, for programs that took at
    least half a second to compile.
    """
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = os.path.join(REPO_ROOT, ".jax_cache")
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return jax.config.jax_compilation_cache_dir
