"""ba_solve_s (s): the window's time over the solves completed in it, each
solve a bundle adjustment that met the traffic's stop rule."""


def read(run):
    units = run.stats["units"]
    return run.window_s / units if units else None
