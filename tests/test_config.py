"""Config-layer tests."""
import os

import numpy as np
import pytest

from gpu_se_tpu import config


def test_defaults_match_canonical_rig():
    cfg = config.SimConfig()
    assert cfg.mpc.P == 300 and cfg.mpc.M == 200
    assert cfg.filter.n_particles == 2**15


def test_horizons_follow_dt_control():
    # Python float floor: 300 // 0.1 == 2999.0 — the reference computes
    # horizons the same way (int(300 // dt_control), sim_base.py:76), so
    # the "P=3000" configuration is actually P=2999 there too.
    mpc = config.MPCConfig(dt_control=0.1)
    assert mpc.P == 2999 and mpc.M == 1999
    mpc = config.MPCConfig(dt_control=30)
    assert mpc.P == 10 and mpc.M == 6


def test_build_rig():
    cfg = config.SimConfig(
        filter=config.FilterConfig(n_particles=64),
        mpc=config.MPCConfig(dt_control=2),
    )
    bioreactor, lin_model, K, est = config.build_rig(cfg)
    assert K.P == 150
    assert est.N_particles == 64
    assert np.isfinite(bioreactor.X).all()


@pytest.fixture
def restore_cache_config():
    import jax

    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_config):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = config.enable_compile_cache()
    assert path == os.path.join(config.REPO_ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)


def test_compile_cache_follows_environment(monkeypatch, tmp_path,
                                           restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    helper sets no directory of its own."""
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    path = config.enable_compile_cache()
    assert path == before == jax.config.jax_compilation_cache_dir
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.5
