"""lm_iter_ms (ms): the solves' time (the untraced window) over all their
LM iterations."""


def read(run):
    n = run.stats["lm_iterations"]
    return 1e3 * run.window_s / n if n else None
