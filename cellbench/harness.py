"""One run of one cell: the pool, the warm-up, the measured window, the
check and the result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file found by its name in ``BENCHMARK.json``:

  * a configuration: ``BENCHMARK.json``'s ``file`` for it, which names
    its generator, ``gen/<generator>.py`` (``make(n, seed, device,
    **generator_params)``);
  * a traffic mix: ``traffic/<traffic>.json``, read by ``traffic.py``;
  * a metric: ``e2e/<name>.py`` or ``layers/<name>.py``, whose
    ``read(run)`` returns the value in the metric's unit, or None when
    the run holds nothing to read (the metric is then left out).

The window drives what the port's CLI runs on one device, as three calls
each fenced by a device synchronise and named by a span of its own:
``as_byte_tensor`` (staging the host bytes), ``build_sa_lcp`` (the
router: fused carried keys above ``SA_LCP_BIG_MIN``, otherwise
``build_suffix_array`` then ``build_lcp_array``) and
``find_longest_repeated_substring``. Builds run back to back, each on
the next text of the pool, until the window's seconds have passed.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import random
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from cellbench import devtrace, reference, traffic

HERE = pathlib.Path(__file__).resolve().parent
# Top-level module names that may not be loaded in a run's process.
BANNED = ("jax", "jaxlib", "flax", "hpc_suffix_array_tpu")


class Bench:
    """``BENCHMARK.json`` and the files it names, under ``bench_dir``
    (this directory by default; ``BENCHMARK.json`` is in its parent)."""

    def __init__(self, bench_dir=HERE):
        self.dir = pathlib.Path(bench_dir)
        self.root = self.dir.parent
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for entry in self.spec[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"BENCHMARK.json has no {key} entry named {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        path = self.root / self._entry("configs", name)["file"]
        return json.loads(path.read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        """``<kind>/<name>.py`` loaded as a module of its own."""
        path = self.dir / kind / f"{name}.py"
        safe = "".join(c if c.isalnum() else "_" for c in name)
        spec = importlib.util.spec_from_file_location(
            f"cellbench_{kind}_{safe}", path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(f"no {kind} file {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: end-to-end untraced,
        per-layer traced."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[key]
                if cell in m.get("workloads", [cell])]


@dataclasses.dataclass
class PortAPI:
    """The three calls of a build."""
    stage: object
    build: object
    lrs: object


def port_api() -> PortAPI:
    from hpc_suffix_array_tpu_torch.core.lcp import build_sa_lcp
    from hpc_suffix_array_tpu_torch.core.lrs import (
        find_longest_repeated_substring)
    from hpc_suffix_array_tpu_torch.core.suffix_array import as_byte_tensor

    return PortAPI(as_byte_tensor, build_sa_lcp,
                   find_longest_repeated_substring)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Build:
    """One build: its text, fenced spans (host clock, seconds), the
    program's ``info``, and the program's peak device bytes."""
    text: int
    n: int
    start: float
    stage_s: float = 0.0
    sa_lcp_s: float = 0.0
    lrs_s: float = 0.0
    end: float = 0.0
    info: dict = dataclasses.field(default_factory=dict)
    peak: int = 0
    traced: bool = False
    error: str | None = None
    outputs: tuple | None = None

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def route(self) -> str:
        return (f"{self.info.get('path', '?')}+"
                f"{self.info.get('lcp_path', 'fused')}")


def build_once(api: PortAPI, text: np.ndarray, dev: torch.device,
               index: int = 0) -> Build:
    """Index the host bytes ``text``: SA, LCP and LRS."""
    rf = torch.profiler.record_function
    sync(dev)
    b = Build(text=index, n=len(text), start=time.perf_counter())
    with rf("cellbench: stage"):
        t = api.stage(text, dev)
        sync(dev)
    t1 = time.perf_counter()
    with rf("cellbench: sa_lcp"):
        sa, lcp = api.build(text, device=dev, info=b.info, text_dev=t)
        sync(dev)
    t2 = time.perf_counter()
    with rf("cellbench: lrs"):
        lrs = api.lrs(t, sa, lcp, device=dev)
        sync(dev)
    b.end = time.perf_counter()
    b.stage_s, b.sa_lcp_s, b.lrs_s = t1 - b.start, t2 - t1, b.end - t2
    b.outputs = (sa, lcp, lrs)
    return b


class Sample:
    """Up to ``per_route`` builds of each route, kept for the check by
    reservoir sampling with a generator seeded from the run's seed."""

    def __init__(self, per_route: int, seed: int):
        self.k = per_route
        self.rng = random.Random(traffic.derive(seed, 2))
        self.seen: dict[str, int] = {}
        self.kept: dict[str, list] = {}

    def offer(self, b: Build) -> None:
        c = self.seen[b.route] = self.seen.get(b.route, 0) + 1
        slot = self.kept.setdefault(b.route, [])
        item = (b.text, *b.outputs)
        if len(slot) < self.k:
            slot.append(item)
        else:
            j = self.rng.randrange(c)
            if j < self.k:
                slot[j] = item

    def device_bytes(self) -> int:
        return sum(x.nbytes for slot in self.kept.values() for item in slot
                   for x in item[1:3] if x.device.type != "cpu")

    def items(self) -> list:
        return [(route, *item) for route in sorted(self.kept)
                for item in self.kept[route]]


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    builds: list
    trace: dict | None = None

    @property
    def done(self) -> list:
        return [b for b in self.builds if b.error is None]

    @property
    def plain(self) -> list:
        """The finished builds the profiler did not slow (all of them
        when every build was traced)."""
        return [b for b in self.done if not b.traced] or self.done


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, api: PortAPI | None = None,
             log=sys.stderr) -> tuple[dict, list]:
    """One run of cell ``name``: the result line's object, and the
    routes of the builds the check judged. ``t_start``:
    ``time.perf_counter()`` when the process began its set-up."""
    dev = torch.device(device)
    api = api or port_api()
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    tr = bench.traffic(cell["traffic"])
    gen = bench.module("gen", config["generator"])
    metrics = [(m, bench.module("layers" if traced else "e2e", m["name"]))
               for m in bench.metrics(name, traced)]

    pool = traffic.make_pool(tr, gen.make, seed, dev,
                             **config.get("generator_params", {}))
    rounds = traffic.order(tr, seed, len(pool))
    device_peak = _peak(dev)
    # Warm-up: one text of each size, its last in the round, so the
    # window's first build is of another text than the warm-up's last. A
    # second text of a size the warm-up has built takes the same route
    # and shapes.
    for i in {len(pool[i]): i for i in rounds}.values():
        _reset_peak(dev)
        build_once(api, pool[i], dev, i)
        device_peak = max(device_peak, _peak(dev))

    sample = Sample(int(tr["check_per_route"]), seed)
    n_trace = int(tr["trace_builds"]) if traced else 0
    prof = _profiler(dev) if traced else None
    builds: list[Build] = []
    sync(dev)
    t_window = time.perf_counter()
    while True:
        i = rounds[len(builds) % len(rounds)]
        held = sample.device_bytes()
        _reset_peak(dev)
        try:
            b = build_once(api, pool[i], dev, i)
        except Exception:           # a failed build is counted, not fatal
            sync(dev)
            b = Build(text=i, n=len(pool[i]), start=time.perf_counter())
            b.end = b.start
            b.error = traceback.format_exc()
            if not any(x.error for x in builds):
                print(b.error, file=log)
        else:
            sample.offer(b)
            b.outputs = None
        peak = _peak(dev)
        device_peak = max(device_peak, peak)
        b.peak = peak - held
        b.traced = len(builds) < n_trace
        builds.append(b)
        if prof is not None and len(builds) == n_trace:
            prof.__exit__(None, None, None)
        if time.perf_counter() - t_window >= seconds:
            break
    if prof is not None and len(builds) < n_trace:
        prof.__exit__(None, None, None)
    run = Run(setup_s=t_window - t_start, builds=builds,
              trace=None if prof is None else _read_trace(prof, builds))
    del prof

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    report(builds, pool, log)
    t_check = time.perf_counter()
    checks = check(sample, pool, dev)
    print(f"check: {time.perf_counter() - t_check:.3f} s", file=log)
    values = {}
    for m, mod in metrics:
        v = mod.read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    failed = sum(b.error is not None for b in builds)
    out = {
        "correct": failed == 0 and bool(checks["checked"]) and all(
            c["value"] <= c["limit"] for c in checks["numbers"].values()),
        "attempted": len(builds),
        "failed": failed,
        "metrics": values,
        "device": device_record(dev, int(cell["chips"]), device_peak,
                                run.trace),
    }
    if run.trace is not None:
        out["breakdown"] = run.trace["breakdown"]
    out["checks"] = checks["numbers"]
    return out, checks["checked"]


def _profiler(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _read_trace(prof, builds: list) -> dict | None:
    """The profiler's Chrome trace, written under ``TMPDIR``, read and
    deleted."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return devtrace.summarize(devtrace.load(path),
                                  sum(b.traced for b in builds))
    finally:
        os.unlink(path)


def report(builds: list, pool: list, log) -> None:
    """Each text's size, mean build ms and build count, to ``log``."""
    per_text: dict[int, list] = {}
    for b in builds:
        if b.error is None:
            per_text.setdefault(b.text, []).append(1e3 * b.seconds)
    print("build ms by text (n, mean, count): " + json.dumps(
        [[len(pool[i]), round(sum(v) / len(v), 3), len(v)]
         for i, v in sorted(per_text.items())]), file=log)


def check(sample: Sample, pool: list, dev: torch.device) -> dict:
    """Judge every kept build against the plain reference, on the text
    the harness made: the sums of its numbers beside their limits, and
    how many builds were judged."""
    items = sample.items()
    sample.kept.clear()
    numbers = {k: 0 for k in reference.LIMITS}
    for _, idx, sa, lcp, lrs in items:
        got = reference.judge(pool[idx], sa, lcp, lrs, dev)
        del sa, lcp
        for k in numbers:
            numbers[k] += got[k]
    return {"checked": [route for route, *_ in items],
            "numbers": {k: {"value": v, "limit": reference.LIMITS[k]}
                        for k, v in numbers.items()}}


def device_record(dev: torch.device, chips: int, peak: int,
                  trace: dict | None) -> dict:
    rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
           "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu"),
           "count": chips,
           "memory_peak_bytes": int(peak)}
    if trace is not None:
        rec["busy_s"] = trace["busy_s"]
        rec["window_s"] = trace["window_s"]
    return rec


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is in ``BANNED``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def check_lines(result: dict) -> list[str]:
    """The compared numbers beside their limits, one per line."""
    return [f"check {k} {c['value']} limit {c['limit']}"
            for k, c in result["checks"].items()]
