"""syncs_per_lm_iter (count): host synchronizations with the card (the
runtime's ``*Synchronize`` calls, which every device-to-host read makes) in
the window over its LM iterations."""


def read(run):
    n = run.stats["lm_iterations"]
    if run.trace is None or not n:
        return None
    return run.trace["syncs"] / n
