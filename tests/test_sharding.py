"""Multi-device tests on the virtual 8-CPU mesh (SURVEY.md section 4 item 8):
shard-invariance of the PF step and agreement between the GSPMD auto path
and the explicit shard_map path."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_se_tpu.distributions import GaussianSum
from gpu_se_tpu.filters import particle as pf_core
from gpu_se_tpu.parallel import (
    make_auto_sharded_step,
    make_mesh,
    make_shard_map_step,
    shard_pf_state,
)
from gpu_se_tpu.models import bioreactor as bio


N = 1024


@pytest.fixture(scope="module")
def rig():
    x_ss = np.array([280 / 180, 640 / 24.6, 1000 / 116, 0.0, 0.0])
    x0 = GaussianSum.create(
        np.stack([x_ss, x_ss]),
        np.stack([np.eye(5) * 1e-4, np.eye(5) * 1e-3]),
        np.array([0.75, 0.25]),
    )
    state_pdf = GaussianSum.create(
        np.zeros((2, 5)),
        np.stack(
            [
                np.diag([1e-4, 1e-7, 1e-3, 1e-3, 1e-7]),
                np.diag([1e-3, 1e-6, 1e-2, 1e-2, 1e-6]),
            ]
        ),
        np.array([0.75, 0.25]),
    )
    meas_pdf = GaussianSum.create(
        np.array([[1e-1, 0], [0, -1e-1]]),
        np.array([[[6e-2, 0], [0, 8e-2]], [[500, 100], [100, 700]]]),
        np.array([0.85, 0.15]),
    )
    f = bio.Bioreactor.homeostatic_DEs
    g = bio.Bioreactor.static_outputs
    u = jnp.array([0.06, 0.2])
    z = jnp.asarray(bio.static_outputs(x_ss, np.asarray(u), xp=np), jnp.float32)
    state = pf_core.init(jax.random.PRNGKey(0), N, x0)
    return dict(x0=x0, state_pdf=state_pdf, meas_pdf=meas_pdf, f=f, g=g, u=u,
                z=z, state=state)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_auto_sharded_matches_single_device(rig):
    """GSPMD-sharded step == single-device step, bitwise-tolerant."""
    mesh8 = make_mesh(8)
    step8 = make_auto_sharded_step(mesh8, rig["f"], rig["g"])

    # single-device reference
    ref = pf_core.step(
        rig["state"], rig["u"], rig["z"], jnp.float32(0.1),
        rig["f"], rig["g"], rig["state_pdf"], rig["meas_pdf"],
    )
    sharded_state = shard_pf_state(rig["state"], mesh8)
    out = step8(
        sharded_state, rig["u"], rig["z"], jnp.float32(0.1),
        rig["state_pdf"], rig["meas_pdf"],
    )
    np.testing.assert_allclose(
        np.asarray(out.particles), np.asarray(ref.particles), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(np.asarray(out.weights), np.asarray(ref.weights))


def test_shard_map_matches_single_device(rig):
    """Explicit shard_map pipeline (local scan + offset + all_gather)
    produces the same resampled ensemble as the single-device step run
    with the identical key schedule."""
    mesh8 = make_mesh(8)
    stepm = make_shard_map_step(mesh8, rig["f"], rig["g"])
    out = stepm(
        shard_pf_state(rig["state"], mesh8), rig["u"], rig["z"], jnp.float32(0.1),
        rig["state_pdf"], rig["meas_pdf"],
    )

    # replicate the key schedule of make_shard_map_step on one device
    state = rig["state"]
    key, k_noise, k_r = jax.random.split(state.key, 3)
    noise = rig["state_pdf"].draw(k_noise, (N,))
    r = jax.random.uniform(k_r, ())
    parts = state.particles + jax.vmap(rig["f"], in_axes=(0, None, None))(
        state.particles, rig["u"], jnp.float32(0.1)
    ) + noise
    ys = jax.vmap(rig["g"], in_axes=(0, None))(parts, rig["u"])
    weights = state.weights * rig["meas_pdf"].pdf(rig["z"] - ys)
    from gpu_se_tpu.filters.resampling import systematic_resample_indices

    idx = systematic_resample_indices(weights, r)
    expected = jnp.take(parts, idx, axis=0)

    np.testing.assert_allclose(
        np.asarray(out.particles), np.asarray(expected), rtol=2e-5, atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(out.weights), 1.0 / N)


def test_shard_map_multi_step_stays_finite(rig):
    mesh8 = make_mesh(8)
    stepm = make_shard_map_step(mesh8, rig["f"], rig["g"])
    state = shard_pf_state(rig["state"], mesh8)
    for _ in range(5):
        state = stepm(
            state, rig["u"], rig["z"], jnp.float32(0.1),
            rig["state_pdf"], rig["meas_pdf"],
        )
    est = np.asarray(pf_core.point_estimate(state))
    assert np.isfinite(est).all()


def test_mesh_sizes_1_2_4_8_agree(rig):
    """Same result for every mesh width (shard-invariance across sizes)."""
    results = []
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(nd)
        step = make_auto_sharded_step(mesh, rig["f"], rig["g"])
        out = step(
            shard_pf_state(rig["state"], mesh), rig["u"], rig["z"],
            jnp.float32(0.1), rig["state_pdf"], rig["meas_pdf"],
        )
        results.append(np.asarray(out.particles))
    for r_ in results[1:]:
        np.testing.assert_allclose(r_, results[0], rtol=1e-6, atol=1e-7)


def test_big_n_width_invariance(rig):
    """Big-N regime (2^22 total particles, the reference's GTX-1070 scale,
    /root/reference/tests/ParallelParticleFilter_test.py:5): the explicit
    shard_map step is bitwise width-invariant. The pre-fix local-scan +
    f32-offset cumsum grouped the summation differently per width and
    moved the point estimate ~3% between widths 2 and 8 at this N."""
    n = 2 ** 22
    state = pf_core.init(jax.random.PRNGKey(2), n, rig["x0"])
    results = []
    for nd in (2, 8):
        mesh = make_mesh(nd)
        step = make_shard_map_step(mesh, rig["f"], rig["g"])
        out = step(
            shard_pf_state(state, mesh), rig["u"], rig["z"], jnp.float32(0.1),
            rig["state_pdf"], rig["meas_pdf"],
        )
        results.append(np.asarray(out.particles))
        del out
    # bitwise: identical cumsum input => identical ancestors => identical sets
    np.testing.assert_array_equal(results[0], results[1])
    assert np.isfinite(results[0]).all()
    # and the blocked-reduction point estimate matches an accurate float64
    # numpy mean (guards the ulp-starvation bug in ops/reduce.py)
    est = np.asarray(
        pf_core.point_estimate(
            pf_core.PFState(
                particles=jnp.asarray(results[0]),
                weights=jnp.full((n,), 1.0 / n, jnp.float32),
                key=jax.random.PRNGKey(0),
            )
        )
    )
    ref = results[0].astype(np.float64).mean(axis=0)
    np.testing.assert_allclose(est, ref, rtol=1e-5, atol=1e-7)


def test_big_n_shard_map_matches_single_device_moments(rig):
    """At 2^21 the sharded resample agrees with the single-device
    scatter+cummax formulation DISTRIBUTIONALLY. Bitwise row agreement is
    unattainable between the two f32 formulations at this N: where cum
    increments are a few ulps (near-uniform weight runs), a 1-ulp
    threshold difference shifts a stretch of ancestors by +-1 particle —
    statistically equivalent draws, different rows (~14% observed). The
    bitwise claim across mesh widths is test_big_n_width_invariance."""
    n = 2 ** 21
    state = pf_core.init(jax.random.PRNGKey(3), n, rig["x0"])
    mesh = make_mesh(8)
    step = make_shard_map_step(mesh, rig["f"], rig["g"])
    out = step(
        shard_pf_state(state, mesh), rig["u"], rig["z"], jnp.float32(0.1),
        rig["state_pdf"], rig["meas_pdf"],
    )

    # single-device replication of the key schedule
    key, k_noise, k_r = jax.random.split(state.key, 3)
    noise = rig["state_pdf"].draw(k_noise, (n,))
    r = jax.random.uniform(k_r, ())

    @jax.jit
    def single(state, noise, r):
        parts = state.particles + jax.vmap(rig["f"], in_axes=(0, None, None))(
            state.particles, rig["u"], jnp.float32(0.1)
        ) + noise
        ys = jax.vmap(rig["g"], in_axes=(0, None))(parts, rig["u"])
        weights = state.weights * rig["meas_pdf"].pdf(rig["z"] - ys)
        from gpu_se_tpu.filters.resampling import systematic_resample_indices

        idx = systematic_resample_indices(weights, r)
        return jnp.take(parts, idx, axis=0)

    expected = np.asarray(single(state, noise, r), dtype=np.float64)
    got = np.asarray(out.particles, dtype=np.float64)
    np.testing.assert_allclose(
        got.mean(axis=0), expected.mean(axis=0), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(
        got.std(axis=0), expected.std(axis=0), rtol=2e-2, atol=1e-4
    )


def test_gsukf_shard_map_matches_key_schedule(rig):
    """Explicit shard_map GSUKF (per-shard predict/update + distributed
    resample of the (means, covariances) bank) reproduces the single-device
    math under the identical key schedule."""
    from gpu_se_tpu.filters import gs_ukf
    from gpu_se_tpu.filters.resampling import systematic_resample_indices
    from gpu_se_tpu.parallel import make_shard_map_gsukf_step, shard_gsukf_state

    n = 64
    state = gs_ukf.init(jax.random.PRNGKey(0), n, rig["x0"], rig["state_pdf"])
    mesh8 = make_mesh(8)
    stepm = make_shard_map_gsukf_step(mesh8, rig["f"], rig["g"])
    out = stepm(
        shard_gsukf_state(state, mesh8), rig["u"], rig["z"], jnp.float32(0.1),
        rig["state_pdf"], rig["meas_pdf"],
    )

    # replicate the key schedule on one device
    nx = state.means.shape[1]
    key, k_noise, k_r = jax.random.split(state.key, 3)
    noise = rig["state_pdf"].draw(k_noise, (n, 2 * nx + 1))
    r = jax.random.uniform(k_r, ())
    means, covs = gs_ukf.predict_core(
        state.means, state.covariances, rig["u"], jnp.float32(0.1), noise, rig["f"]
    )
    means, covs, weights = gs_ukf.update_core(
        means, covs, state.weights, rig["u"], rig["z"], rig["g"], rig["meas_pdf"]
    )
    idx = systematic_resample_indices(weights, r)
    np.testing.assert_allclose(
        np.asarray(out.means), np.asarray(jnp.take(means, idx, axis=0)),
        rtol=2e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(out.covariances), np.asarray(jnp.take(covs, idx, axis=0)),
        rtol=1e-4, atol=1e-6,
    )
    np.testing.assert_allclose(np.asarray(out.weights), 1.0 / n)


def test_gsukf_shard_map_mesh_sizes_agree(rig):
    from gpu_se_tpu.filters import gs_ukf
    from gpu_se_tpu.parallel import make_shard_map_gsukf_step, shard_gsukf_state

    n = 64
    state = gs_ukf.init(jax.random.PRNGKey(1), n, rig["x0"], rig["state_pdf"])
    results = []
    for nd in (1, 2, 4, 8):
        mesh = make_mesh(nd)
        stepm = make_shard_map_gsukf_step(mesh, rig["f"], rig["g"])
        out = stepm(
            shard_gsukf_state(state, mesh), rig["u"], rig["z"], jnp.float32(0.1),
            rig["state_pdf"], rig["meas_pdf"],
        )
        results.append((np.asarray(out.means), np.asarray(out.covariances)))
    for m_, c_ in results[1:]:
        np.testing.assert_allclose(m_, results[0][0], rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(c_, results[0][1], rtol=1e-4, atol=1e-6)


def test_gsukf_auto_sharded_matches_single_device(rig):
    """GSPMD-sharded GSUKF step == single-device step."""
    from gpu_se_tpu.filters import gs_ukf
    from gpu_se_tpu.parallel import make_auto_sharded_gsukf_step, shard_gsukf_state

    n = 64
    state = gs_ukf.init(jax.random.PRNGKey(0), n, rig["x0"], rig["state_pdf"])
    ref = gs_ukf.step(
        state, rig["u"], rig["z"], jnp.float32(0.1),
        rig["f"], rig["g"], rig["state_pdf"], rig["meas_pdf"],
    )
    mesh8 = make_mesh(8)
    step8 = make_auto_sharded_gsukf_step(mesh8, rig["f"], rig["g"])
    out = step8(
        shard_gsukf_state(state, mesh8), rig["u"], rig["z"], jnp.float32(0.1),
        rig["state_pdf"], rig["meas_pdf"],
    )
    # rtol loosened 1e-5 -> 1e-4 in round 4: the per-sigma accumulation
    # rewrite of update_core reassociates f32 sums, and GSPMD's
    # partitioned fusion orders them slightly differently than the
    # single-device lowering (observed max 3e-5 relative on 1/320
    # elements)
    np.testing.assert_allclose(
        np.asarray(out.means), np.asarray(ref.means), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.covariances), np.asarray(ref.covariances), rtol=1e-4, atol=3e-6
    )


def test_2e23_full_step_width_invariance(rig):
    """2^23 total particles — the regime SURVEY section 7 assigns to
    the multi-device path — run SHARDED on the CPU mesh: the
    full shard_map step is bitwise width-invariant (fixed-segment cumsum
    + ring exchange; n_local is a multiple of 128 for both widths)."""
    n = 2 ** 23
    state = pf_core.init(jax.random.PRNGKey(5), n, rig["x0"])
    results = []
    for nd in (2, 8):
        mesh = make_mesh(nd)
        step = make_shard_map_step(mesh, rig["f"], rig["g"])
        out = step(
            shard_pf_state(state, mesh), rig["u"], rig["z"], jnp.float32(0.1),
            rig["state_pdf"], rig["meas_pdf"],
        )
        results.append(np.asarray(out.particles))
        del out
    np.testing.assert_array_equal(results[0], results[1])
    assert np.isfinite(results[0]).all()


def test_2e24_resample_width_invariance_and_memory(rig):
    """2^24 particles — the reference's max exercised count
    (/root/reference/tests/ParallelParticleFilter_test.py:5) — resampled
    SHARDED: (a) bitwise identical rows for widths 4 and 8 under
    adversarially skewed weights, (b) per-shard temp memory of the
    compiled resample stays O(n_global / n_shards): the ring exchange
    never materializes the global pool (the old all-gather path held the
    full 2^24 x 5 f32 pool = 336 MB live per shard; memory_analysis()
    reports per-device stats)."""
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from gpu_se_tpu.parallel.sharded import _distributed_systematic_resample
    from gpu_se_tpu.parallel.mesh import PARTICLE_AXIS

    n = 2 ** 24
    key = jax.random.PRNGKey(7)

    def build(nd):
        mesh = make_mesh(nd)
        p_sh = NamedSharding(mesh, P(PARTICLE_AXIS, None))
        w_sh = NamedSharding(mesh, P(PARTICLE_AXIS))
        r_sh = NamedSharding(mesh, P())

        @partial(jax.jit, in_shardings=(p_sh, w_sh, r_sh),
                 out_shardings=(p_sh, w_sh))
        def res(parts, w, r):
            @partial(
                shard_map, mesh=mesh,
                in_specs=(P(PARTICLE_AXIS, None), P(PARTICLE_AXIS), P()),
                out_specs=(P(PARTICLE_AXIS, None), P(PARTICLE_AXIS)),
                check_vma=False,
            )
            def body(parts, w, r):
                return _distributed_systematic_resample(
                    parts, w, r, PARTICLE_AXIS
                )
            return body(parts, w, r)

        # sharded inputs built once per width; threefry_partitionable
        # makes the draw width-invariant
        parts = jax.device_put(
            jax.random.normal(key, (n, 5), jnp.float32), p_sh
        )
        w = jax.device_put(jnp.exp(4.0 * jnp.tanh(parts[:, 0]) ** 2), w_sh)
        return res, parts, w

    res8, parts8, w8 = build(8)
    out8, _ = res8(parts8, w8, jnp.float32(0.417))
    got8 = np.asarray(out8)
    del out8

    # (b) compiled per-shard memory bound, checked before the width-4 run
    ma = res8.lower(parts8, w8, jnp.float32(0.417)).compile().memory_analysis()
    del parts8, w8
    if ma is not None and ma.temp_size_in_bytes:
        n_local_bytes = (n // 8) * 5 * 4
        assert ma.temp_size_in_bytes < n * 5 * 4, (
            f"temp {ma.temp_size_in_bytes} suggests a full-pool gather"
        )
        assert ma.temp_size_in_bytes < 4 * n_local_bytes, (
            f"temp {ma.temp_size_in_bytes} is not O(n_local)={n_local_bytes}"
        )

    res4, parts4, w4 = build(4)
    out4, _ = res4(parts4, w4, jnp.float32(0.417))
    got4 = np.asarray(out4)
    del out4, parts4, w4
    np.testing.assert_array_equal(got8, got4)
    assert np.isfinite(got8).all()


def _raw_distributed_resample(nd, n, parts_np, w_np, r, impl):
    """Run one raw distributed resample (no predict/update) on a width-nd
    mesh and return the gathered rows."""
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from gpu_se_tpu.parallel.sharded import (
        _distributed_systematic_resample,
        _distributed_systematic_resample_a2a,
    )
    from gpu_se_tpu.parallel.mesh import PARTICLE_AXIS

    mesh = make_mesh(nd)
    p_sh = NamedSharding(mesh, P(PARTICLE_AXIS, None))
    w_sh = NamedSharding(mesh, P(PARTICLE_AXIS))
    r_sh = NamedSharding(mesh, P())

    @partial(jax.jit, in_shardings=(p_sh, w_sh, r_sh),
             out_shardings=(p_sh, w_sh))
    def res(parts, w, r):
        @partial(
            shard_map, mesh=mesh,
            in_specs=(P(PARTICLE_AXIS, None), P(PARTICLE_AXIS), P()),
            out_specs=(P(PARTICLE_AXIS, None), P(PARTICLE_AXIS)),
            check_vma=False,
        )
        def body(parts, w, r):
            if impl == "xla":
                return _distributed_systematic_resample(
                    parts, w, r, PARTICLE_AXIS)
            assert impl == "a2a_ring", impl
            return _distributed_systematic_resample_a2a(
                parts, w, r, PARTICLE_AXIS, exchange="ring")
        return body(parts, w, r)

    parts = jax.device_put(jnp.asarray(parts_np), p_sh)
    w = jax.device_put(jnp.asarray(w_np), w_sh)
    out, _ = res(parts, w, jnp.float32(r))
    return np.asarray(out)


def _weight_families(n, rng):
    one_hot_mid = np.zeros(n, np.float32)
    one_hot_mid[n // 2] = 1.0
    one_hot_last = np.zeros(n, np.float32)
    one_hot_last[-1] = 1.0
    blocks = rng.random(n).astype(np.float32)
    blocks[: n // 3] = 0.0
    blocks[2 * n // 3:] = 0.0
    heavy = np.exp(8.0 * rng.standard_normal(n)).astype(np.float32)
    return {
        "uniform": np.full(n, 1.0 / n, np.float32),
        "one_hot_mid": one_hot_mid,
        "one_hot_last": one_hot_last,
        "zero_blocks": blocks / blocks.sum(),
        "heavy_tail": heavy / heavy.sum(),
    }


def test_a2a_resample_matches_ring_all_weight_families():
    """Compact/exchange/merge protocol == ring protocol, BITWISE, for
    every weight family (uniform, point masses, zeroed blocks, heavy
    tails) at every mesh width.

    The baseline is the RING protocol on the same raw weights: both
    consume the identical width-invariant ``_segmented_ends``; the
    single-device ``systematic_resample_indices`` groups its f32 cumsum
    differently and may differ by an ulp-shifted boundary (observed: 20
    rows of 2^14 in the zero_blocks family) — a formulation difference,
    not a protocol bug (cf. test_big_n_shard_map_matches_single_device_
    moments)."""
    n = 2 ** 14
    rng = np.random.default_rng(0)
    parts_np = rng.standard_normal((n, 5)).astype(np.float32)
    r = 0.417

    for name, w_np in _weight_families(n, rng).items():
        expected = _raw_distributed_resample(1, n, parts_np, w_np, r, "xla")
        for nd in (1, 2, 4, 8):
            got = _raw_distributed_resample(
                nd, n, parts_np, w_np, r, "a2a_ring")
            np.testing.assert_array_equal(
                got, expected, err_msg=f"a2a_ring W={nd} family={name}")


def test_a2a_full_step_width_invariance_2e23(rig):
    """The a2a protocol at the 2^23 multi-device scale: the full
    shard_map step (resample_impl='a2a_ring') is bitwise width-invariant.

    NOT asserted: bitwise equality of the a2a and ring FULL steps.
    Different resample consumers change how XLA fuses the upstream
    predict/update, reordering the f32 weight arithmetic by ulps, which
    legitimately moves degenerate-regime resample boundaries (~18% of
    rows observed in this rig). The protocols' bitwise equality on
    identical raw weights is test_a2a_resample_matches_ring_all_weight_
    families."""
    n = 2 ** 23
    state = pf_core.init(jax.random.PRNGKey(5), n, rig["x0"])
    results = []
    for nd in (2, 8):
        mesh = make_mesh(nd)
        step = make_shard_map_step(mesh, rig["f"], rig["g"],
                                   resample_impl="a2a_ring")
        out = step(
            shard_pf_state(state, mesh), rig["u"], rig["z"], jnp.float32(0.1),
            rig["state_pdf"], rig["meas_pdf"],
        )
        results.append(np.asarray(out.particles))
        del out
    np.testing.assert_array_equal(results[0], results[1])
    assert np.isfinite(results[0]).all()


def test_a2a_memory_stays_local_2e24(rig):
    """The a2a exchange never materializes the global pool: per-shard
    temp memory of the compiled 2^24 resample stays O(n_global/W), the
    same bound the ring path is pinned to."""
    from functools import partial
    from jax.sharding import NamedSharding, PartitionSpec as P
    from jax import shard_map

    from gpu_se_tpu.parallel.sharded import _distributed_systematic_resample_a2a
    from gpu_se_tpu.parallel.mesh import PARTICLE_AXIS

    n = 2 ** 24
    mesh = make_mesh(8)
    p_sh = NamedSharding(mesh, P(PARTICLE_AXIS, None))
    w_sh = NamedSharding(mesh, P(PARTICLE_AXIS))
    r_sh = NamedSharding(mesh, P())

    @partial(jax.jit, in_shardings=(p_sh, w_sh, r_sh),
             out_shardings=(p_sh, w_sh))
    def res(parts, w, r):
        @partial(
            shard_map, mesh=mesh,
            in_specs=(P(PARTICLE_AXIS, None), P(PARTICLE_AXIS), P()),
            out_specs=(P(PARTICLE_AXIS, None), P(PARTICLE_AXIS)),
            check_vma=False,
        )
        def body(parts, w, r):
            return _distributed_systematic_resample_a2a(
                parts, w, r, PARTICLE_AXIS, exchange="ring")
        return body(parts, w, r)

    key = jax.random.PRNGKey(7)
    parts = jax.device_put(jax.random.normal(key, (n, 5), jnp.float32), p_sh)
    w = jax.device_put(jnp.exp(4.0 * jnp.tanh(parts[:, 0]) ** 2), w_sh)
    ma = res.lower(parts, w, jnp.float32(0.417)).compile().memory_analysis()
    if ma is not None and ma.temp_size_in_bytes:
        n_local_bytes = (n // 8) * 5 * 4
        assert ma.temp_size_in_bytes < n * 5 * 4
        assert ma.temp_size_in_bytes < 6 * n_local_bytes
    out, _ = res(parts, w, jnp.float32(0.417))
    assert np.isfinite(np.asarray(out[:16])).all()


def test_gsukf_a2a_matches_xla_ring(rig):
    """The GSUKF bank (multi-leaf pytree, 30 packed cols) through the a2a
    protocol matches the ring protocol bitwise."""
    from gpu_se_tpu.filters import gs_ukf
    from gpu_se_tpu.parallel import make_shard_map_gsukf_step, shard_gsukf_state

    n = 64
    state = gs_ukf.init(jax.random.PRNGKey(1), n, rig["x0"], rig["state_pdf"])
    outs = []
    for impl in ("xla", "a2a_ring"):
        mesh = make_mesh(8)
        stepm = make_shard_map_gsukf_step(mesh, rig["f"], rig["g"],
                                          resample_impl=impl)
        out = stepm(
            shard_gsukf_state(state, mesh), rig["u"], rig["z"], jnp.float32(0.1),
            rig["state_pdf"], rig["meas_pdf"],
        )
        outs.append((np.asarray(out.means), np.asarray(out.covariances)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_non_power_of_two_mesh_width(rig):
    """The ring protocol assumes nothing about the mesh width: width 3
    (non-power-of-two, non-divisor of 8) agrees with width 1 bitwise
    when shard sizes stay multiples of the 128-slot segment."""
    n = 3 * 512
    state = pf_core.init(jax.random.PRNGKey(11), n, rig["x0"])
    results = []
    for nd in (1, 3):
        mesh = make_mesh(nd)
        step = make_shard_map_step(mesh, rig["f"], rig["g"])
        out = step(
            shard_pf_state(state, mesh), rig["u"], rig["z"], jnp.float32(0.1),
            rig["state_pdf"], rig["meas_pdf"],
        )
        results.append(np.asarray(out.particles))
    np.testing.assert_array_equal(results[0], results[1])


@pytest.mark.parametrize("impl", ("kernel", "a2a", "a2a_ring_v4", "a2a_tiled_ring"))
def test_unknown_resample_impl_rejected(rig, impl):
    """Only the ring ("xla") and the a2a protocols ("a2a_xla" ragged,
    "a2a_ring" emulated) exist for the PF step."""
    with pytest.raises(ValueError, match="resample_impl"):
        make_shard_map_step(make_mesh(2), rig["f"], rig["g"], resample_impl=impl)


def test_unknown_gsukf_resample_impl_rejected(rig):
    from gpu_se_tpu.parallel import make_shard_map_gsukf_step

    with pytest.raises(ValueError, match="resample_impl"):
        make_shard_map_gsukf_step(make_mesh(2), rig["f"], rig["g"],
                                  resample_impl="kernel")
