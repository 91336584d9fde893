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
    between the first and the last of them;
  * the recorder: ``span`` (named host intervals, and CUDA events at
    both ends of a device span), ``count`` (integer counters) and
    ``record`` (one build's spans and counters, written into the build's
    ``info``). Spans and counters stay in memory; a ``torch.profiler``
    session sees every span as a ``record_function`` of its name, so the
    Chrome trace (``device_trace``) is their only export.
"""

from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import time

import torch

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


# --- the span-and-counter recorder ------------------------------------------

# Holds Python's copy of the profiler's on flag (set while a
# ``torch.profiler`` session records): one attribute read, where
# ``record_function`` costs microseconds even with the profiler off.
_PROF = torch.autograd.profiler


class Record:
    """One build's spans and counters.

    ``spans`` holds one ``[name, start, end, parent]`` per span, in the
    order the spans opened: host seconds on ``time.perf_counter``'s
    clock (end None while the span is open) and the index of the
    innermost span open at its start (-1 for none). ``counters`` maps a
    name to an int. Device spans wait in ``pending`` as (index, start
    event, end event) until ``resolve`` reads them into ``device_ms``;
    ``device_counters`` maps (name, device) to an accumulator on the
    device (``device_counter``), read into ``counters`` at the close."""

    def __init__(self):
        self.spans: list[list] = []
        self.open: list[int] = []
        self.pending: list[tuple] = []
        self.device_ms: dict[int, float] = {}
        self.counters: dict[str, int] = {}
        self.device_counters: dict[tuple, torch.Tensor] = {}

    def mark(self) -> int:
        """The index of the next span: ``totals(since=mark())`` reads the
        spans opened after this call."""
        return len(self.spans)

    def totals(self, since: int = 0) -> dict:
        """name -> {"ms", "calls"} summed over the closed spans from
        index ``since``, with "device_ms" for resolved device spans."""
        out: dict = {}
        for i in range(since, len(self.spans)):
            name, t0, t1, _ = self.spans[i]
            if t1 is None:
                continue
            acc = out.setdefault(name, {"ms": 0.0, "calls": 0})
            acc["ms"] += 1e3 * (t1 - t0)
            acc["calls"] += 1
            if i in self.device_ms:
                acc["device_ms"] = (acc.get("device_ms", 0.0)
                                    + self.device_ms[i])
        return out

    def self_ms(self) -> dict:
        """name -> summed ms of the closed spans less the time their
        direct children cover."""
        own = [1e3 * (t1 - t0) if t1 is not None else 0.0
               for _, t0, t1, _ in self.spans]
        for _, t0, t1, parent in self.spans:
            if parent >= 0 and t1 is not None:
                own[parent] -= 1e3 * (t1 - t0)
        out: dict = {}
        for (name, _, t1, _), ms in zip(self.spans, own):
            if t1 is not None:
                out[name] = out.get(name, 0.0) + ms
        return out

    def resolve(self) -> None:
        """Device ms of every pending span whose end event has completed;
        the others stay pending. Waits for nothing."""
        left = []
        for i, a, b in self.pending:
            if b.query():
                self.device_ms[i] = a.elapsed_time(b)
            else:
                left.append((i, a, b))
        self.pending = left

    def summary(self) -> dict:
        """The ``info`` keys of the build: ``spans_ms``, ``span_self_ms``
        and ``counters``."""
        spans = {name: {k: round(v, 3) if isinstance(v, float) else v
                        for k, v in acc.items()}
                 for name, acc in self.totals().items()}
        return {"spans_ms": spans,
                "span_self_ms": {k: round(v, 3)
                                 for k, v in self.self_ms().items()},
                "counters": dict(self.counters)}


_open: Record | None = None
_process_spans: dict[str, list] = {}        # name -> [ms, calls]
_process_counters: dict[str, int] = {}


def _event(device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class span:
    """A named host interval; a context manager, or a decorator of a
    function whose every call it covers.

    With a build record open (``record``) it goes into the record, under
    the innermost open span; outside one, into the process table
    (``process_spans``), as does every ``process`` span. While a
    ``torch.profiler`` session records, it also opens
    ``record_function(name)``, so the trace holds it on the clock of the
    device's kernels. With no record, no profiler and ``process`` False
    it does nothing beyond one flag check.

    ``device``: the device the enclosed work is queued on. A CUDA device
    makes it a device span: inside a record, a CUDA event is recorded on
    the device's current stream at each end, and ``resolve`` reads their
    interval after a host read that waited for it. It adds no
    synchronisation and allocates no device memory."""

    __slots__ = ("name", "device", "process", "_rec", "_i", "_t0", "_rf",
                 "_ev")

    def __init__(self, name: str, device=None, process: bool = False):
        self.name, self.process = name, process
        self.device = (torch.device(device) if device is not None
                       and torch.device(device).type == "cuda" else None)

    def __call__(self, fn):
        name, device, process = self.name, self.device, self.process

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name, device, process):
                return fn(*args, **kwargs)
        return wrapped

    def __enter__(self):
        rec, prof = _open, _PROF._is_profiler_enabled
        self._t0 = None
        if rec is None and not prof and not self.process:
            return self
        self._rec, self._rf, self._ev = rec, None, None
        if prof:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if rec is not None:
            self._i = len(rec.spans)
            rec.spans.append([self.name, 0.0, None,
                              rec.open[-1] if rec.open else -1])
            rec.open.append(self._i)
            if self.device is not None:
                self._ev = _event(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self._t0 is None:
            return
        t1 = time.perf_counter()
        rec = self._rec
        if rec is not None:
            entry = rec.spans[self._i]
            entry[1], entry[2] = self._t0, t1
            rec.open.pop()
            if self._ev is not None:
                rec.pending.append((self._i, self._ev,
                                    _event(self.device)))
        if rec is None or self.process:
            acc = _process_spans.setdefault(self.name, [0.0, 0])
            acc[0] += 1e3 * (t1 - self._t0)
            acc[1] += 1
        if self._rf is not None:
            self._rf.__exit__(None, None, None)


def device_counter(name: str, device) -> torch.Tensor | None:
    """The open record's accumulator of counter ``name`` on ``device``: a
    zeroed int64[1] tensor that kernels add to, the same one for every
    call in the record, read with one host read when the record closes
    and added to ``name`` there. None unless a record is open while a
    ``torch.profiler`` session records (a traced build), so an untraced
    build passes a kernel no accumulator and reads nothing back."""
    rec = _open
    if rec is None or not _PROF._is_profiler_enabled:
        return None
    key = (name, str(device))
    acc = rec.device_counters.get(key)
    if acc is None:
        # A copy from the host, not a fill kernel: a traced build launches
        # the kernels an untraced one does.
        acc = rec.device_counters[key] = torch.zeros(
            1, dtype=torch.int64).to(device)
    return acc


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` in the open record and in the
    process table (``process_counters``)."""
    _process_counters[name] = _process_counters.get(name, 0) + k
    if _open is not None:
        _open.counters[name] = _open.counters.get(name, 0) + k


@contextlib.contextmanager
def record(top: str, info: dict | None = None, own: bool = False):
    """The build record of an entry point.

    Inside an open record this joins it, as a span named ``top``.
    Otherwise, where ``info`` is given or ``own`` is set, it opens a
    record under the top span ``top`` and on exit writes its
    ``summary`` (``spans_ms``: name -> summed ms and calls, with
    ``device_ms`` for device spans; ``span_self_ms``; ``counters``) into
    ``info``. Yields the record, or None where none is open."""
    global _open
    if _open is not None:
        with span(top):
            yield _open
        return
    if info is None and not own:
        yield None
        return
    rec = _open = Record()
    try:
        with span(top):
            yield rec
    finally:
        _open = None
        for (name, _), acc in rec.device_counters.items():
            k = int(acc.item())
            _process_counters[name] = _process_counters.get(name, 0) + k
            rec.counters[name] = rec.counters.get(name, 0) + k
        rec.resolve()
        if info is not None:
            info.update(rec.summary())


def resolve() -> None:
    """Read the open record's finished device spans (call it after a host
    read that waited for their work)."""
    if _open is not None and _open.pending:
        _open.resolve()


def process_spans() -> dict:
    """name -> {"ms", "calls"} of the spans recorded outside any build
    record, and of every ``process`` span, since the process began."""
    return {k: {"ms": round(v[0], 3), "calls": v[1]}
            for k, v in _process_spans.items()}


def process_counters() -> dict:
    """name -> every ``count`` since the process began (or the name's
    last ``reset_counters``)."""
    return dict(_process_counters)


def reset_counters(*names: str) -> None:
    """Zero the named counters of the process table."""
    for name in names:
        _process_counters.pop(name, None)
