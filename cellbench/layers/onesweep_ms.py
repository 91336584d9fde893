"""The radix-sort kernels (``onesweep_pass``, ``digit_histograms``),
device ms per traced build."""

from cellbench.readers import kernel_ms, port_kernel


def read(run):
    return kernel_ms(run, lambda name: port_kernel(
        name, "onesweep_pass_kernel", "digit_histograms_kernel"))
