"""Plain PyTorch's kernels (every kernel that is not the port's own:
post-sort, doubling, PLCP, refinement, LCP fetch), device ms per traced
build; copies and fills are not kernels and are left out."""

from cellbench.readers import kernel_ms, port_kernel


def read(run):
    return kernel_ms(run, lambda name: not port_kernel(name))
