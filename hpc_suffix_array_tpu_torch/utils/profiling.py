"""Phase timing and device tracing.

Counterpart of ``hpc_suffix_array_tpu/utils/profiling.py``:

  * ``phase_timer``: wall-clock phase timing, fenced at both ends. CUDA
    launches return at enqueue, so an unfenced end reads the clock
    before the work is done, and an unfenced start charges the previous
    phase's tail to this one;
  * ``device_trace``: a ``torch.profiler`` context that writes a Chrome
    trace (``chrome://tracing``, Perfetto) into a directory;
  * ``read_trace`` / ``device_busy``: the device's kernels and copies
    out of such a trace, and the busy and idle share of the window
    between the first and the last of them.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time

from hpc_suffix_array_tpu_torch.device import resolve_device, synchronize

TRACE_NAME = "trace.json"
# Chrome-trace categories of work that occupies the device.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _short(name: str, width: int = 96) -> str:
    """A demangled kernel name cut to ``width`` characters."""
    return name if len(name) <= width else name[:width - 3] + "..."


class PhaseTimings(dict):
    """Phase-name -> seconds; insertion-ordered, printable."""

    def report(self) -> str:
        total = sum(self.values())
        lines = [f"  {k:24s} {v:10.6f} s  ({v / total:6.1%})"
                 for k, v in self.items()] if total else []
        return "\n".join(lines + [f"  {'total':24s} {total:10.6f} s"])


@contextlib.contextmanager
def phase_timer(timings: PhaseTimings, name: str, device, fence=None):
    """Time a phase into ``timings[name]`` (accumulating).

    ``fence()`` runs before the clock starts and before it stops; the
    default waits for all work queued on ``device`` (a no-op on the
    CPU)."""
    fence = fence or (lambda: synchronize(device))
    fence()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        fence()
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def device_trace(log_dir, device):
    """``torch.profiler`` trace of the enclosed work: CPU activity
    always, CUDA activity when ``device`` is a card.

    Yields the profiler (its ``events()`` and ``key_averages()`` are
    readable after the block) and on exit, also when the block raised,
    writes ``log_dir/trace.json``. Queued device work is waited for
    before the window closes, so the trace holds all of it."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        synchronize(dev)
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(out / TRACE_NAME))


def read_trace(log_dir) -> list[dict]:
    """The complete events ('ph' X: name, cat, ts and dur in
    microseconds) of ``log_dir/trace.json``."""
    with open(pathlib.Path(log_dir) / TRACE_NAME) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def device_busy(events: list[dict], n_top: int = 10, n_gaps: int = 5) -> dict:
    """Busy and idle share of the device in a trace's events.

    The window runs from the first device event's start to the last
    one's end; overlapping events are merged, so ``busy_ms`` counts no
    instant twice. Returns ``n_events``, ``window_ms``, ``busy_ms``,
    ``idle_share``, ``top`` (the ``n_top`` names with the most device
    time: name cut to 96 characters, ms, count) and ``gaps`` (the ``n_gaps`` longest idle
    intervals: ms, offset ``at_ms`` into the window, the device events
    ``after`` and ``before`` which the device idled, and ``host``: the
    CPU-side events with the longest overlap, name and ms). Raises
    ValueError when the trace holds no device event."""
    dev = sorted((e for e in events if e.get("cat") in DEVICE_CATEGORIES),
                 key=lambda e: e["ts"])
    if not dev:
        raise ValueError("the trace holds no device event")
    by_name: dict[str, list[float]] = {}
    for e in dev:
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1
    start = dev[0]["ts"]
    gaps = []
    end, last = start, dev[0]
    for e in dev:
        if e["ts"] > end:
            gaps.append((e["ts"] - end, end, last["name"], e["name"]))
        if e["ts"] + e["dur"] > end:
            end, last = e["ts"] + e["dur"], e
    window = end - start
    busy = window - sum(g[0] for g in gaps)
    gaps.sort(reverse=True)
    # The profiler's own span covers the whole window and says nothing.
    host = [e for e in events if e.get("cat") not in DEVICE_CATEGORIES
            and not e["name"].startswith("PyTorch Profiler")]

    def host_during(t0: float, t1: float) -> list[dict]:
        over = {}
        for e in host:
            o = min(e["ts"] + e["dur"], t1) - max(e["ts"], t0)
            if o > 0:
                over[e["name"]] = over.get(e["name"], 0.0) + o
        best = sorted(over.items(), key=lambda kv: -kv[1])[:4]
        return [{"name": k, "ms": round(v / 1e3, 3)} for k, v in best]

    return {
        "n_events": len(dev),
        "window_ms": window / 1e3,
        "busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window if window else 0.0,
        "top": [{"name": _short(k), "ms": round(v[0] / 1e3, 3), "count": v[1]}
                for k, v in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][0])[:n_top]],
        "gaps": [{"ms": round(g / 1e3, 3),
                  "at_ms": round((t0 - start) / 1e3, 3),
                  "after": _short(a), "before": _short(b),
                  "host": host_during(t0, t0 + g)}
                 for g, t0, a, b in gaps[:n_gaps]],
    }
