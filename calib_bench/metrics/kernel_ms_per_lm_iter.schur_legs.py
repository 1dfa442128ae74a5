"""kernel_ms_per_lm_iter.schur_legs (ms): the card's time in the two
kernels of the point-eliminated Schur legs (``schur_point_leg_kernel`` and
``schur_pose_leg_kernel``: both passes of every CG matvec, the reduced
right-hand side and the back-substitution) per LM iteration; None where
they never ran."""

from calib_bench.trace import kernel_seconds


def read(run):
    n = run.stats["lm_iterations"]
    if run.trace is None or not n:
        return None
    seconds, count = kernel_seconds(run.trace, "schur_point_leg_kernel",
                                    "schur_pose_leg_kernel")
    return 1e3 * seconds / n if count else None
