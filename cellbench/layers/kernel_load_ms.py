"""The kernel library's load from disk, ms: the program's process span
"kernels: load" less the compile inside it ("kernels: compile", a
checkout's first run), so a run that compiled reads the same quantity as
one that did not."""


def read(run):
    from hpc_suffix_array_tpu_torch.utils import profiling

    spans = getattr(profiling, "process_spans", None)
    if spans is None:
        return None
    table = spans()
    load = table.get("kernels: load")
    if load is None:
        return None
    return load["ms"] - table.get("kernels: compile", {"ms": 0.0})["ms"]
