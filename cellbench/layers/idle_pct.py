"""The device's idle share of the traced window, %."""


def read(run):
    return None if run.trace is None else 100.0 * run.trace["idle_share"]
