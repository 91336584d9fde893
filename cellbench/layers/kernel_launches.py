"""Device kernels per traced build, every kernel in the trace."""


def read(run):
    if run.trace is None or not run.trace["n_builds"]:
        return None
    count = sum(v[1] for v in run.trace["kernels"].values())
    return count / run.trace["n_builds"]
