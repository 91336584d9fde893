"""The readers of the program's spans and counters (``plan_ms``,
``direct_post_sort_ms``, ``residue_ms``, ``sort_GBps``, ``k1_GBps``,
``kernel_load_ms``) on a synthetic run, on the CPU.

    python -m pytest cellbench/tests -q
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cellbench import devtrace, harness  # noqa: E402

BENCH = harness.Bench()
NAMES = ("plan_ms", "direct_post_sort_ms", "residue_ms", "sort_GBps",
         "k1_GBps", "kernel_load_ms")


def read(name: str, run) -> float | None:
    return BENCH.module("layers", name).read(run)


def _build(traced: bool, info: dict) -> harness.Build:
    b = harness.Build(text=0, n=1, start=0.0, info=info)
    b.traced = traced
    return b


def _info(plan: float, post: float, residue: float, sort: int,
          k1: int) -> dict:
    return {"spans_ms": {
        "sa_lcp": {"ms": 900.0, "calls": 1},
        "host: alphabet_remap": {"ms": plan, "calls": 1},
        "host: estimate_repeat_len": {"ms": 2 * plan, "calls": 1},
        "host: route_plan": {"ms": 0.5, "calls": 2},
        "direct: post_sort": {"ms": 1.0, "calls": 1, "device_ms": post},
        "host: residue": {"ms": residue, "calls": 1}},
        "counters": {"sort_bytes": sort, "k1_bytes": k1}}


def _kernel(name: str, ts: float, dur: float) -> dict:
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def _run() -> harness.Run:
    """Two traced builds and two plain ones; the trace holds 3 ms of
    sort kernels and 1 ms of K1 (device µs)."""
    trace = devtrace.summarize([
        _kernel("(anonymous namespace)::onesweep_pass_kernel(Cols, int)",
                0, 2500),
        _kernel("(anonymous namespace)::digit_histograms_kernel(Words)",
                2500, 500),
        _kernel("void (anonymous namespace)::pack_words_kernel<2, 0>("
                "unsigned char const*)", 3000, 1000),
        _kernel("void at::native::x<int>(int)", 4000, 7000),
    ], 2)
    builds = [_build(True, _info(10.0, 40.0, 400.0, 6_000_000_000,
                                 1_000_000_000)),
              _build(True, _info(10.0, 40.0, 400.0, 3_000_000_000,
                                 1_000_000_000)),
              _build(False, _info(10.0, 50.0, 380.0, 1, 1)),
              _build(False, _info(20.0, 54.0, 420.0, 1, 1))]
    return harness.Run(setup_s=1.0, builds=builds, trace=trace)


def test_the_span_readers_take_the_plain_builds(monkeypatch):
    run = _run()
    assert read("plan_ms", run) == pytest.approx((30.5 + 60.5) / 2)
    assert read("direct_post_sort_ms", run) == pytest.approx(52.0)
    assert read("residue_ms", run) == pytest.approx(400.0)


def test_the_rates_take_the_traced_builds_only():
    run = _run()
    # 9e9 B over 3000 µs and 2e9 B over 1000 µs.
    assert read("sort_GBps", run) == pytest.approx(3000.0)
    assert read("k1_GBps", run) == pytest.approx(2000.0)
    run.builds[1].error = "failed"
    assert read("sort_GBps", run) == pytest.approx(2000.0)


def test_the_readers_give_none_where_nothing_ran(monkeypatch):
    from hpc_suffix_array_tpu_torch.utils import profiling

    bare = harness.Run(setup_s=1.0, builds=[_build(True, {}),
                                            _build(False, {})])
    monkeypatch.setattr(profiling, "_process_spans", {})
    assert {name: read(name, bare) for name in NAMES} == dict.fromkeys(NAMES)
    # A program without the recorder (an older checkout) reads nothing.
    monkeypatch.delattr(profiling, "process_spans")
    assert read("kernel_load_ms", bare) is None
    # A trace without the port's kernels gives no rate.
    run = _run()
    run.trace["kernels"] = {"void at::native::x<int>(int)": [7000.0, 1]}
    assert read("sort_GBps", run) is None and read("k1_GBps", run) is None


@pytest.mark.parametrize("spans,ms", [
    ({"kernels: load": [12.25, 1]}, 12.25),
    # A run that compiled reads its load less the compile inside it.
    ({"kernels: load": [6112.5, 1], "kernels: compile": [6100.25, 1]},
     12.25)])
def test_kernel_load_ms_reads_the_load_without_the_compile(monkeypatch,
                                                           spans, ms):
    from hpc_suffix_array_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "_process_spans", spans)
    assert read("kernel_load_ms", _run()) == pytest.approx(ms)


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_is_listed_with_its_cells(name):
    entry = next(m for m in BENCH.spec["per_layer"] if m["name"] == name)
    cells = {w["name"] for w in BENCH.spec["workloads"]}
    assert set(entry["workloads"]) <= cells
    assert entry["moves"] in {m["name"] for m in BENCH.spec["end_to_end"]}
