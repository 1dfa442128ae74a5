"""kernel_ms_per_lm_iter.project_ncg (ms): the card's time in the
NoncentralGeneric projection kernel (``ncg_projection_kernel``, the
projection loop of the blocks and the cost pass) per LM iteration; None
where it never ran."""

from calib_bench.trace import kernel_seconds


def read(run):
    n = run.stats["lm_iterations"]
    if run.trace is None or not n:
        return None
    seconds, count = kernel_seconds(run.trace, "ncg_projection_kernel")
    return 1e3 * seconds / n if count else None
