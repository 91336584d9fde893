"""The exact host residue (``_apply_residue``), host ms per build (the
program's span "host: residue")."""

from cellbench.readers import info_mean


def read(run):
    return info_mean(run, lambda i: i.get("spans_ms", {})
                     .get("host: residue", {}).get("ms"))
