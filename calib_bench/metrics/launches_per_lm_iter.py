"""launches_per_lm_iter (count): kernels the profiler saw run on the card
in the window over the window's LM iterations."""


def read(run):
    n = run.stats["lm_iterations"]
    if run.trace is None or not n or not run.trace["launches"]:
        return None
    return run.trace["launches"] / n
