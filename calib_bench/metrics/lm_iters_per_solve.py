"""lm_iters_per_solve (count): LM iterations (the length of each solve's
``info["history"]``) over the solves of the window."""


def read(run):
    units = run.stats["units"]
    return run.stats["lm_iterations"] / units if units else None
