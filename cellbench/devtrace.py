"""Reading a ``torch.profiler`` Chrome trace: device busy and idle time,
device time by kernel name, and the longest idle gaps with what the host
was doing in them.

The arithmetic is the port's ``utils/profiling.py::device_busy``,
copied: the device window runs from the first device event's start to
the last one's end, overlapping device events are merged so that no
instant counts twice, and a gap is an interval of the window that no
device event covers. A gap is named by the innermost host event that
covers half of it or more (the harness's and the program's spans, an
aten op, a CUDA runtime call).
"""

from __future__ import annotations

import json

# Chrome-trace categories of work that occupies the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
WIDTH = 96


def load(path) -> list[dict]:
    """The complete events ('ph' X: name, cat, ts and dur in
    microseconds) of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _short(name: str) -> str:
    return name if len(name) <= WIDTH else name[:WIDTH - 3] + "..."


def summarize(events: list[dict], n_builds: int) -> dict | None:
    """``busy_s``, ``window_s``, ``idle_share``, ``kernels`` (name ->
    [device µs, count], kernels only), ``n_builds`` and the result
    line's ``breakdown``; None when the trace holds no device event."""
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATEGORIES),
                 key=lambda e: e["ts"])
    if not dev:
        return None
    by_name: dict[str, list] = {}
    kernels: dict[str, list] = {}
    for e in dev:
        tables = (by_name, kernels) if e["cat"] == "kernel" else (by_name,)
        for table in tables:
            acc = table.setdefault(e["name"], [0.0, 0])
            acc[0] += e["dur"]
            acc[1] += 1
    start = dev[0]["ts"]
    gaps = []
    end = start
    for e in dev:
        if e["ts"] > end:
            gaps.append((e["ts"] - end, end))
        end = max(end, e["ts"] + e["dur"])
    window = end - start
    busy = window - sum(g for g, _ in gaps)
    gaps.sort(reverse=True)
    host = [e for e in events if e.get("cat") not in DEVICE_CATEGORIES
            and not e["name"].startswith("PyTorch Profiler")]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": busy / 1e6,
        "window_s": window / 1e6,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "kernels": kernels,
        "n_builds": n_builds,
        "breakdown": {
            "device_ops": [[_short(k), v[0] / 1e6] for k, v in top_ops],
            "idle_gaps": [[_short(host_in(host, t0, t0 + g)), g / 1e6]
                          for g, t0 in gaps[:TOP]],
        },
    }


def host_in(host: list[dict], t0: float, t1: float) -> str:
    """The shortest host event that covers at least half of [t0, t1),
    else the one that covers most of it; "idle host" when none
    overlaps it."""
    half, best, most = (t1 - t0) / 2, None, (0.0, "idle host")
    for e in host:
        o = min(e["ts"] + e["dur"], t1) - max(e["ts"], t0)
        if o >= half and (best is None or e["dur"] < best["dur"]):
            best = e
        if o > most[0]:
            most = (o, e["name"])
    return best["name"] if best is not None else most[1]
