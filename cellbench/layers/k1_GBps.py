"""The K1 fold's achieved rate, GB/s: the program's "k1_bytes" counter
(the text bytes read and the key words written, once) of the traced
builds over the device time of ``pack_words`` in the same builds."""

from cellbench.readers import port_kernel


def read(run):
    if run.trace is None:
        return None
    moved = sum(b.info.get("counters", {}).get("k1_bytes", 0)
                for b in run.builds if b.traced and b.error is None)
    us = sum(v[0] for k, v in run.trace["kernels"].items()
             if port_kernel(k, "pack_words_kernel"))
    return moved / us / 1e3 if moved and us else None
