"""roofline.window (%): the least time the three window kernels' calls of
the traced window could take (each call's bytes for the observation rows
the deployment has, each input read once and each output written once,
over the HBM rate; ``calib_bench/work``), over the card's time in them (the
profiler's ``apply_j_kernel``, ``window_partial_kernel`` and
``window_sum_kernel``).  Calls are the program's launch counts of
``window_apply_j``, ``window_apply_jtw`` and ``window_block_diag`` in the
window."""

from calib_bench import peaks
from calib_bench.trace import kernel_seconds

KERNELS = ("window_apply_j", "window_apply_jtw", "window_block_diag")


def read(run):
    shape = run.shapes.get("window")
    if run.trace is None or shape is None:
        return None
    least = 0.0
    for name in KERNELS:
        calls = run.launches.get(name, 0)
        if calls:
            least += calls * peaks.bound_s(*run.work(name)(**shape))[0]
    seconds, count = kernel_seconds(run.trace, "apply_j_kernel",
                                    "window_partial_kernel",
                                    "window_sum_kernel")
    if not count or not least:
        return None
    return 100.0 * least / seconds
