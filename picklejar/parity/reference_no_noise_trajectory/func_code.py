# first line: 24
@PickleJar.pickle(
    "parity",
    # pin the committed cache: GPU_SE_PICKLEJAR_ROOT (set by the
    # experiment smokes) must not redirect this 13-minute memo
    root=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "picklejar",
    ),
)
def reference_no_noise_trajectory(dt_control, end_time):
    """Deterministic reference trajectory: the sparse simultaneous-form QP
    (controller.py layout) solved by the independent float64 ADMM, driven
    through the no-noise loop. Expensive (~minutes) and fully
    deterministic, so it is PickleJar-cached and the cache directory is
    committed — the same cached-results methodology the reference repo
    uses (/root/reference/README.md:22-38). Delete picklejar/parity/ to
    force regeneration."""
    _, lin_model, K_ours, _ = sim.get_parts(
        dt_control=dt_control, N_particles=8, pf=True
    )
    K_ref = ReferenceLayoutMPC(
        P=K_ours.P, M=K_ours.M, Q=K_ours.Q, R=K_ours.R,
        lin=lin_model, ysp=K_ours.ysp,
        u_bounds=[
            np.array([0, np.inf]) - lin_model.u_bar[0],
            np.array([0, np.inf]) - lin_model.u_bar[1],
        ],
    )
    ts, us_ref, xs_ref, ys_ref = run_no_noise_loop(
        K_ref, lin_model, end_time=end_time, dt_control=dt_control
    )
    return ts, us_ref, ys_ref
