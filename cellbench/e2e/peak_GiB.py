"""The most device memory one build of the window allocated
(``torch.cuda.max_memory_allocated`` after a reset at the build's start,
less what the harness held for the check), GiB."""


def read(run):
    if not run.done:
        return None
    return max(b.peak for b in run.done) / (1 << 30)
