"""device_idle.ba (%): the share of the window in which no operation ran on
the card (1 − the union of the device's busy intervals over the window)."""


def read(run):
    if run.trace is None or not run.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
