"""The K1 fold (``pack_words``), device ms per traced build."""

from cellbench.readers import kernel_ms, port_kernel


def read(run):
    return kernel_ms(run, lambda name: port_kernel(name, "pack_words_kernel"))
