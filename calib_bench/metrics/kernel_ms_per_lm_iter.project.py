"""kernel_ms_per_lm_iter.project (ms): the card's time in the projection
kernels (``project`` and ``project_blocks``, both ``project_kernel``) per
LM iteration."""

from calib_bench.trace import kernel_seconds


def read(run):
    n = run.stats["lm_iterations"]
    if run.trace is None or not n:
        return None
    seconds, count = kernel_seconds(run.trace, "project_kernel")
    return 1e3 * seconds / n if count else None
