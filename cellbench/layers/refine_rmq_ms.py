"""RangeMin's construction, queries and updates, device ms per build
(the program's device span "refine: rmq", CUDA events)."""

from cellbench.readers import info_mean


def read(run):
    return info_mean(run, lambda i: i.get("spans_ms", {})
                     .get("refine: rmq", {}).get("device_ms"))
