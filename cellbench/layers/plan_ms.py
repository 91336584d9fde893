"""Host planning, ms per build: the program's four planning spans
(alphabet remap, repeat estimate, bucket-edge sampling and the route
choice) summed from ``info["spans_ms"]``."""

from cellbench.readers import info_mean

PLANNING = ("host: alphabet_remap", "host: estimate_repeat_len",
            "host: sample_edges", "host: route_plan")


def read(run):
    def planning(info):
        spans = info.get("spans_ms")
        if spans is None:
            return None
        return sum(spans[name]["ms"] for name in PLANNING if name in spans)
    return info_mean(run, planning)
