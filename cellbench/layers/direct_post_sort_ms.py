"""The direct builder's post-sort pass, device ms per build (the
program's device span "direct: post_sort", CUDA events)."""

from cellbench.readers import info_mean


def read(run):
    return info_mean(run, lambda i: i.get("spans_ms", {})
                     .get("direct: post_sort", {}).get("device_ms"))
