"""The port's span-and-counter recorder (``utils/profiling.py``).

Spans nest under the innermost open one and give self times; counters
go to the open build record and to the process table; with no record
and no profiler a span does nothing; a device counter exists only in a
record open while a profiler records, and is read into the record's
counters at its close. A ``torch.profiler`` session sees
each span as a ``user_annotation`` around the ops it covers. The
builders write the expected span names and counters on every route the
CPU can force (direct, MSD, refinement with a host residue, doubling +
PLCP), the doubling rounds and RangeMin have their spans and counters
where the doubling runs and none where it does not, the older ``info``
keys and ``launch_counts()`` keep their keys,
and the byte counters equal their formulas on the plain CPU path.
"""

import time

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu_torch as tsa
from hpc_suffix_array_tpu_torch import kernels
from hpc_suffix_array_tpu_torch.core import bigsort as tbs
from hpc_suffix_array_tpu_torch.core import refine as trf
from hpc_suffix_array_tpu_torch.datasets import (
    generate_random_text, generate_words_text)
from hpc_suffix_array_tpu_torch.kernels.pack import pack_ranks, pack_words
from hpc_suffix_array_tpu_torch.kernels.radix import radix_sort_words
from hpc_suffix_array_tpu_torch.utils import profiling as prof
from hpc_suffix_array_tpu_torch.utils.profiling import (
    count, device_trace, process_counters, process_spans, read_trace,
    record, span)


def _planted(n: int = 1 << 15, seed: int = 11) -> np.ndarray:
    """Random letters with one 2000-byte block at three sites: a few
    window ties that the host residue orders."""
    rng = np.random.default_rng(seed)
    text = rng.integers(97, 123, n).astype(np.uint8)
    for pos in (3_000, 13_000, 23_000):
        text[pos:pos + 2000] = text[:2000]
    return text


def test_spans_nest_with_parents_and_self_time():
    info: dict = {}
    with record("top", info) as rec:
        with span("a"):
            time.sleep(0.01)
            with span("b"):
                time.sleep(0.02)
        with span("b"):
            pass
        count("c", 2)
    names = [s[0] for s in rec.spans]
    parents = [s[3] for s in rec.spans]
    assert names == ["top", "a", "b", "b"] and parents == [-1, 0, 1, 0]
    dur = [1e3 * (t1 - t0) for _, t0, t1, _ in rec.spans]
    assert info["spans_ms"]["b"]["calls"] == 2
    assert info["spans_ms"]["a"]["ms"] == pytest.approx(dur[1], abs=1e-3)
    assert info["span_self_ms"]["a"] == pytest.approx(dur[1] - dur[2],
                                                      abs=1e-3)
    assert info["span_self_ms"]["top"] == pytest.approx(
        dur[0] - dur[1] - dur[3], abs=1e-3)
    assert 20 <= info["spans_ms"]["b"]["ms"] < info["spans_ms"]["a"]["ms"]
    assert info["counters"] == {"c": 2}
    assert prof._open is None


def test_an_inner_record_joins_the_open_one():
    outer, inner = {}, {}
    with record("outer", outer) as rec:
        with record("inner", inner) as joined:
            with span("x"):
                pass
        assert joined is rec
    assert inner == {}
    assert [s[0] for s in rec.spans] == ["outer", "inner", "x"]
    assert [s[3] for s in rec.spans] == [-1, 0, 1]
    assert set(outer["spans_ms"]) == {"outer", "inner", "x"}


def test_record_yields_none_without_info_and_a_private_one_when_owned():
    with record("t") as rec:
        assert rec is None and prof._open is None
    with record("t", own=True) as rec:
        with span("x"):
            pass
        assert prof._open is rec
    assert rec.totals()["x"]["calls"] == 1 and prof._open is None


def test_counters_reset_per_build_and_accumulate_in_the_process_table():
    text = generate_random_text(5000, 3)
    before = process_counters()
    infos = [{}, {}]
    for info in infos:
        tsa.build_sa_lcp(text, device="cpu", info=info)
    after = process_counters()
    assert infos[0]["counters"] == infos[1]["counters"]
    assert infos[0]["counters"]["k1_bytes"] > 0
    for name, k in infos[0]["counters"].items():
        assert after[name] - before.get(name, 0) == 2 * k


def test_a_device_counter_exists_only_in_a_traced_record():
    """No accumulator outside a record or without a profiler; inside a
    traced record one zeroed int64[1] a name, the same at every call,
    read into the build's and the process's counters at the close."""
    assert prof.device_counter("x_reads", "cpu") is None
    with record("top", {}):
        assert prof.device_counter("x_reads", "cpu") is None
    before = process_counters().get("x_reads", 0)
    info: dict = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with record("top", info):
            acc = prof.device_counter("x_reads", "cpu")
            assert acc.dtype == torch.int64 and acc.tolist() == [0]
            acc += 5
            assert prof.device_counter("x_reads", "cpu") is acc
            prof.device_counter("x_reads", "cpu").add_(2)
    assert info["counters"]["x_reads"] == 7
    assert process_counters()["x_reads"] == before + 7


def test_a_traced_cpu_sort_counts_no_look_back():
    """The plain CPU pass runs no look-back: a traced record of a CPU
    sort holds neither onesweep counter."""
    cols = [torch.arange(5000, dtype=torch.int32).flip(0),
            torch.arange(5000, dtype=torch.int32)]
    info: dict = {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with record("top", info):
            radix_sort_words(cols[:1], cols[1], 13)
    assert "onesweep_lookback_reads" not in info["counters"]
    assert "onesweep_tiles" not in info["counters"]
    assert info["counters"]["sort_bytes"] == 2 * 5000 * 2 * 4


def test_without_record_or_profiler_a_span_does_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) was called")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    before = process_spans()

    @span("decorated")
    def f(x):
        return x + 1

    with span("plain"):
        assert f(1) == 2
    assert process_spans() == before
    assert prof._open is None


def test_process_spans_outside_and_inside_a_record():
    calls = process_spans().get("p", {"calls": 0})["calls"]
    with span("p", process=True):
        pass
    with record("t", own=True) as rec:
        with span("p", process=True):
            pass
        with span("q"):
            pass
    assert process_spans()["p"]["calls"] == calls + 2
    assert "q" not in process_spans()
    assert [s[0] for s in rec.spans] == ["t", "p", "q"]


def test_a_device_span_on_the_cpu_records_host_time_only():
    with record("t", own=True) as rec:
        with span("d", device="cpu"):
            pass
    assert rec.pending == [] and "device_ms" not in rec.totals()["d"]


def test_spans_lie_around_the_ops_they_cover_in_a_cpu_trace(tmp_path):
    with device_trace(tmp_path, "cpu"):
        with span("outer"):
            x = torch.arange(1 << 16) * 3
            with span("inner"):
                x.sum()
    events = read_trace(tmp_path)
    ann = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation"}

    def inside(e, w):
        return w["ts"] <= e["ts"] and e["ts"] + e["dur"] <= w["ts"] + w["dur"]

    assert inside(ann["inner"], ann["outer"])
    ops = {name: [e for e in events if e["name"] == name]
           for name in ("aten::mul", "aten::sum")}
    assert ops["aten::mul"] and ops["aten::sum"]
    assert all(inside(e, ann["outer"]) for e in ops["aten::mul"])
    assert all(inside(e, ann["inner"]) for e in ops["aten::sum"])
    assert all(not inside(e, ann["inner"]) for e in ops["aten::mul"])


ROUTES = {
    "direct": ({"SA_BIG_THRESHOLD": 1000, "SA_LCP_BIG_MIN": 1000},
               lambda: generate_random_text(40_000, 0), "direct",
               {"sa_lcp", "host: alphabet_remap", "host: estimate_repeat_len",
                "host: route_plan", "direct: sort", "direct: post_sort",
                "direct: residue_extract"},
               {"k1_bytes", "sort_bytes", "post_sort_bytes"}),
    "direct_residue": ({"SA_BIG_THRESHOLD": 1000, "SA_LCP_BIG_MIN": 1000},
                       _planted, "direct",
                       {"direct: sort", "direct: residue_extract",
                        "host: residue"},
                       {"k1_bytes", "sort_bytes", "post_sort_bytes"}),
    "msd": ({"SA_BIG_THRESHOLD": 1000, "SA_LCP_BIG_MIN": 1000,
             "SA_DIRECT_CROSS": 0, "SA_CHUNK_ELEMS": 4096,
             "SA_TARGET_BUCKET": 4096},
            lambda: generate_random_text(40_000, 0), "msd",
            {"sa_lcp", "host: alphabet_remap", "host: estimate_repeat_len",
             "host: route_plan", "host: sample_edges", "msd", "msd: count",
             "msd: scatter", "msd: buckets", "msd: bucket_sort",
             "msd: post_sort", "msd: residue_extract", "msd: finish"},
            {"k1_bytes", "sort_bytes", "post_sort_bytes"}),
    "refine": ({"SA_BIG_THRESHOLD": 1 << 14, "SA_LCP_BIG_MIN": 1 << 14,
                "SA_HOST_RESIDUE_MAX": 8},
               lambda: generate_words_text(1 << 16, 5), "direct",
               {"refine", "refine: extract", "refine: rounds",
                "refine: fetch", "host: residue"},
               {"k1_bytes", "sort_bytes", "post_sort_bytes",
                "refine_round_bytes"}),
    "doubling_plcp": ({}, lambda: generate_random_text(40_000, 0),
                      "doubling",
                      {"sa_lcp", "sa", "doubling", "host: alphabet_remap",
                       "lcp", "plcp"},
                      {"k1_bytes"}),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_build_sa_lcp_writes_the_route_spans_and_counters(route,
                                                          monkeypatch):
    env, make, path, spans, counters = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    info: dict = {}
    tsa.build_sa_lcp(make(), device="cpu", info=info)
    assert info["path"] == path
    got = info["spans_ms"]
    assert spans <= set(got), spans - set(got)
    assert counters <= set(info["counters"])
    assert got["sa_lcp"]["calls"] == 1
    assert set(info["span_self_ms"]) == set(got)
    for name, acc in got.items():
        assert -1e-3 <= info["span_self_ms"][name] <= acc["ms"] + 1e-3
        assert "device_ms" not in acc          # no CUDA events on the CPU
    if route == "refine":
        assert info["counters"]["k1_bytes"] > 0 and info["refine_members"]
        assert got["host: residue"]["calls"] == 1
    if route == "doubling_plcp":
        assert info["rounds"] > 0 and info["plcp_rounds"] > 0


def _planted_dna(n: int = 1 << 16, seed: int = 12) -> np.ndarray:
    """Random ACGT (minpad packing) with one 2000-byte block at three
    sites."""
    rng = np.random.default_rng(seed)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for pos in (20_000, 40_000, 60_000):
        text[pos:pos + 2000] = text[:2000]
    return text


def _doubling_text(case: str, monkeypatch) -> np.ndarray:
    """A planted text and thresholds under which its ties reach the
    doubling rounds on the direct route: one piece under reserved-0
    packing, several pieces, or minpad."""
    env = {"SA_BIG_THRESHOLD": 1 << 14, "SA_LCP_BIG_MIN": 1 << 14,
           "SA_HOST_RESIDUE_MAX": 8, "SA_REFINE_HOST_PIECE": 16}
    if case == "pieces":
        env["SA_REFINE_PIECE"] = 2048
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    return _planted_dna() if case == "minpad" else _planted()


@pytest.mark.parametrize("case", ["one_piece", "pieces", "minpad"])
def test_the_refinement_counts_its_rounds_and_depth(case, monkeypatch):
    """Where the doubling runs, its rank array is built in the span
    "refine: ranks", inside "refine: rounds", and the record counts the
    word rounds (at least one a piece, before the deep ties stall
    them), the doubling rounds and the depth they proved: one piece
    under reserved-0 packing, several pieces, and minpad."""
    info: dict = {}
    tsa.build_sa_lcp(_doubling_text(case, monkeypatch), device="cpu",
                     info=info)
    assert info["path"] == "direct"
    assert (info["refine_pieces"] > 1) == (case == "pieces")
    counters, spans = info["counters"], info["spans_ms"]
    assert {"refine_word_rounds", "refine_doubling_rounds",
            "refine_depth"} <= set(counters)
    assert spans["refine: ranks"]["calls"] == 1
    assert spans["refine: ranks"]["ms"] <= spans["refine: rounds"]["ms"]
    assert counters["refine_word_rounds"] >= info["refine_pieces"]
    assert counters["refine_doubling_rounds"] >= 1
    assert counters["refine_depth"] >= 2 ** counters["refine_doubling_rounds"]


def _spy_doubling(monkeypatch) -> dict:
    """Counts, apart from the program's counters, the rows each doubling
    round sorts, the boundaries it splits (its segments after less its
    segments before) and the calls of RangeMin's construction, query
    and lower."""
    seen = {"rows": 0, "splits": 0, "rmq": 0}
    one_round = trf.doubling_round

    def doubling_round(seg, *args):
        rows, before = seg.shape[0], int(seg[-1]) + 1
        out = one_round(seg, *args)
        seen["rows"] += rows
        seen["splits"] += int(out[0][-1]) + 1 - before
        return out

    def calls(method):
        def wrapped(self, *args):
            seen["rmq"] += 1
            return method(self, *args)
        return wrapped

    monkeypatch.setattr(trf, "doubling_round", doubling_round)
    for name in ("__init__", "query", "lower"):
        monkeypatch.setattr(trf.RangeMin, name,
                            calls(getattr(trf.RangeMin, name)))
    return seen


def _ancestors(spans: list, i: int) -> list[str]:
    names = []
    while spans[i][3] >= 0:
        i = spans[i][3]
        names.append(spans[i][0])
    return names


@pytest.mark.parametrize("case", ["one_piece", "pieces", "minpad"])
def test_the_doubling_and_range_min_have_spans_and_counters(case,
                                                            monkeypatch):
    """Where the doubling runs, "refine: doubling" covers its rounds
    once, inside "refine: rounds" and after "refine: ranks"; every call
    of RangeMin's construction (inside "refine: ranks"), query and lower
    (inside "refine: doubling") is one "refine: rmq" span; and
    ``refine_doubling_rows`` and ``rmq_ranges`` equal the rows the
    rounds sorted and the boundaries they split, counted apart."""
    text = _doubling_text(case, monkeypatch)
    seen = _spy_doubling(monkeypatch)
    info: dict = {}
    with record("test", info) as rec:
        tsa.build_sa_lcp(text, device="cpu", info=info)
    counters, spans = info["counters"], info["spans_ms"]
    assert info["path"] == "direct"
    assert counters["refine_doubling_rounds"] >= 1
    assert counters["refine_doubling_rows"] == seen["rows"] > 0
    assert counters["rmq_ranges"] == seen["splits"] > 0
    assert spans["refine: doubling"]["calls"] == 1
    assert spans["refine: rmq"]["calls"] == seen["rmq"] >= 3
    names = [s[0] for s in rec.spans]
    at = names.index("refine: doubling")
    ranks = names.index("refine: ranks")
    assert _ancestors(rec.spans, at)[0] == "refine: rounds"
    assert ranks < at and rec.spans[ranks][2] <= rec.spans[at][1]
    for i, name in enumerate(names):
        if name == "refine: rmq":
            inside = "refine: ranks" if i < at else "refine: doubling"
            assert inside in _ancestors(rec.spans, i)


def test_a_build_without_doubling_has_neither_span_nor_counter(
        monkeypatch):
    """Plain English of 64 KiB, refined by word rounds alone."""
    from cellbench import harness

    for k, v in {"SA_BIG_THRESHOLD": 1 << 14, "SA_LCP_BIG_MIN": 1 << 14,
                 "SA_HOST_RESIDUE_MAX": 8, "SA_REFINE_HOST_PIECE": 64}.items():
        monkeypatch.setenv(k, str(v))
    bench = harness.Bench()
    params = bench.config("english")["generator_params"]
    text = bench.module("gen", "english").make(1 << 16, 2**31 + 3, "cpu",
                                              **params).numpy()
    info: dict = {}
    tsa.build_sa_lcp(text, device="cpu", info=info)
    assert info["refine_members"] > 0 and info["refine_rounds"] >= 1
    assert info["counters"]["refine_doubling_rounds"] == 0
    assert not {"refine: doubling", "refine: rmq"} & set(info["spans_ms"])
    assert not {"refine_doubling_rows", "rmq_ranges"} & set(
        info["counters"])


@pytest.mark.parametrize("route", ["direct_residue", "refine"])
def test_the_host_residue_counts_its_members_and_steps(route, monkeypatch):
    env, make, path, _, _ = ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    info: dict = {}
    tsa.build_sa_lcp(make(), device="cpu", info=info)
    assert info["path"] == path
    counters = info["counters"]
    assert counters["residue_members"] == info["n_patched"] > 0
    assert 1 <= counters["residue_steps"] <= 64
    assert "residue_exact_pairs" not in counters


def test_the_older_info_keys_and_launch_counts_keep_their_keys(
        monkeypatch):
    for k, v in {"SA_BIG_THRESHOLD": 1000, "SA_DIRECT_CROSS": 0,
                 "SA_CHUNK_ELEMS": 4096, "SA_TARGET_BUCKET": 4096}.items():
        monkeypatch.setenv(k, str(v))
    info: dict = {}
    tbs.build_suffix_array_big(generate_random_text(40_000, 0),
                               device="cpu", info=info)
    assert set(info["phase_host_s"]) == {
        "count", "scatter", "bucket_sorts", "residue_extract", "finish"}
    assert info["phase_host_s"]["bucket_sorts"] > 0
    assert "phase_device_ms" not in info       # CUDA events only
    # Without a caller's record the builder keeps its own.
    state = tbs.prepare_big(generate_random_text(40_000, 0), device="cpu")
    tbs.execute_big(state)
    assert set(state["plan"].meta["phase_host_s"]) == set(
        info["phase_host_s"])

    monkeypatch.setenv("SA_HOST_RESIDUE_MAX", "8")
    rinfo: dict = {}
    tbs.build_suffix_array_direct(generate_words_text(1 << 16, 5),
                                  device="cpu", info=rinfo)
    assert set(rinfo["refine_phase_s"]) == set(trf.REFINE_PHASES) == {
        "extract", "pk", "rounds", "host_fetch"}
    assert rinfo["refine_phase_s"]["rounds"] >= 0

    assert set(kernels.launch_counts()) == {
        "pack_ranks", "pack_words", "digit_histograms", "onesweep_pass",
        "block_digit_sort", "place_runs", "post_sort", "refine_gather",
        "refine_split"}
    assert set(kernels.pass_counts()) == {"passes_run", "passes_skipped"}
    count("launches: pack_words", 3)
    assert kernels.launch_counts()["pack_words"] >= 3
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    assert set(kernels.pass_counts().values()) == {0}


@pytest.mark.parametrize("nw,payload", [(1, True), (2, True), (3, True),
                                        (4, False)])
def test_sort_bytes_equal_the_formula_on_the_cpu(nw, payload):
    n = 10_007
    rng = np.random.default_rng(nw)
    words = [torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32))
             for _ in range(nw)]
    pay = torch.arange(n, dtype=torch.int32) if payload else None
    with record("t", own=True) as rec:
        radix_sort_words(words, pay, 20)
    assert rec.counters == {"sort_bytes": 2 * n * (nw + payload) * 4}


@pytest.mark.parametrize("n_words,offset,n_out,n_real", [
    (1, 0, 1000, 1000), (2, 0, 1000, 900), (3, 7, 500, 1000),
    (2, 990, 10, 1000)])
def test_k1_bytes_equal_the_formula_on_the_cpu(n_words, offset, n_out,
                                               n_real):
    spw, bits = 5, 6
    text = torch.from_numpy(
        np.random.default_rng(1).integers(0, 60, 1000).astype(np.uint8))
    table = torch.arange(256, dtype=torch.int32) % 60
    covered = len(range(offset,
                        min(n_real, offset + n_out + n_words * spw - 1)))
    with record("t", own=True) as rec:
        pack_words(text, table, bits, spw, n_real, n_words, offset=offset,
                   n_out=n_out)
    assert rec.counters == {"k1_bytes": covered + 4 * n_out * n_words}
    with record("t", own=True) as rec:
        pack_ranks(text, table, bits, spw, n_real)
    assert rec.counters == {"k1_bytes": n_real + 4 * 1000}


@pytest.mark.parametrize("kernel", ["sort", "k1"])
def test_a_call_the_device_refuses_counts_no_bytes(kernel):
    text = torch.zeros(100, dtype=torch.uint8, device="meta")
    words = [torch.zeros(100, dtype=torch.int32, device="meta")]
    with record("t", own=True) as rec, pytest.raises(ValueError,
                                                     match="unsupported"):
        if kernel == "sort":
            radix_sort_words(words, None, 20)
        else:
            pack_words(text, torch.zeros(256, dtype=torch.int32,
                                         device="meta"), 6, 5, 100, 1)
    assert rec.counters == {}
