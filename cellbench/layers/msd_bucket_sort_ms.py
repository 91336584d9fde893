"""The MSD builder's bucket sorts, device ms per build (the program's
``info["phase_device_ms"]["bucket_sort"]``, CUDA events)."""

from cellbench.readers import info_mean


def read(run):
    return info_mean(run, lambda i: i.get("phase_device_ms", {})
                     .get("bucket_sort"))
