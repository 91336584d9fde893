"""The harness's fenced span around the ``find_longest_repeated_substring``
call, mean ms per build."""

from cellbench.readers import span_ms


def read(run):
    return span_ms(run, "lrs_s")
