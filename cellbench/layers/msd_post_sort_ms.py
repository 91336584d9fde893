"""The MSD builder's post-sort passes, device ms per build (the
program's ``info["phase_device_ms"]["post_sort"]``, CUDA events)."""

from cellbench.readers import info_mean


def read(run):
    return info_mean(run, lambda i: i.get("phase_device_ms", {})
                     .get("post_sort"))
