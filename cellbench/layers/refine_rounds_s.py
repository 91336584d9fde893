"""The tie refinement's rounds, host s per build (the program's
``info["refine_phase_s"]["rounds"]``)."""

from cellbench.readers import info_mean


def read(run):
    return info_mean(run, lambda i: i.get("refine_phase_s", {})
                     .get("rounds"))
