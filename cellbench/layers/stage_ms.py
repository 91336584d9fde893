"""The harness's fenced span around the staging call
(``as_byte_tensor``), mean ms per build."""

from cellbench.readers import span_ms


def read(run):
    return span_ms(run, "stage_s")
