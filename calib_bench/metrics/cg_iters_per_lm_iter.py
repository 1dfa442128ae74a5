"""cg_iters_per_lm_iter (count): the Schur-PCG iterations of every LM
iteration (``history[*]["pcg_iterations"]``) over the LM iterations."""


def read(run):
    n = run.stats["lm_iterations"]
    return run.stats["pcg_iterations"] / n if n else None
