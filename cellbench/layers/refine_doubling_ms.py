"""The refinement's doubling rounds, device ms per build (the program's
device span "refine: doubling", CUDA events)."""

from cellbench.readers import info_mean


def read(run):
    return info_mean(run, lambda i: i.get("spans_ms", {})
                     .get("refine: doubling", {}).get("device_ms"))
