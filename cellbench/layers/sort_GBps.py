"""The radix-sort kernels' achieved rate, GB/s: the program's
"sort_bytes" counter (every column of every sort read and written once)
of the traced builds over the device time of ``onesweep_pass`` and
``digit_histograms`` in the same builds."""

from cellbench.readers import port_kernel


def read(run):
    if run.trace is None:
        return None
    moved = sum(b.info.get("counters", {}).get("sort_bytes", 0)
                for b in run.builds if b.traced and b.error is None)
    us = sum(v[0] for k, v in run.trace["kernels"].items() if port_kernel(
        k, "onesweep_pass_kernel", "digit_histograms_kernel"))
    return moved / us / 1e3 if moved and us else None
