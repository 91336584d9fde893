"""Set-up: from the process's start to the window's (imports, CUDA
context, kernel library, text pool, warm-up), host clock, s."""


def read(run):
    return run.setup_s
