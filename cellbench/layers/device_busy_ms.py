"""Time in which an operation ran on the device, ms per traced build
(merged device intervals of the trace): the steady reading beside
``index_MBps``, which the host's swings move."""


def read(run):
    if run.trace is None or not run.trace["n_builds"]:
        return None
    return 1e3 * run.trace["busy_s"] / run.trace["n_builds"]
