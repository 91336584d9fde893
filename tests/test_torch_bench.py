"""The port's measurement path against the JAX package's.

Every input is made with numpy from a seed and goes through the JAX
function and its counterpart in the port (``device="cpu"``, the plain
versions of the kernels). Tolerance: none on integers, bytes, CSV columns
and strings; times are only required to be positive (or ordered, on the
fused route), never compared between the packages.
"""

import csv
import hashlib
import json
import time

import numpy as np
import pandas as pd
import pytest
import torch

import hpc_suffix_array_tpu.bench.harness as jharness
import hpc_suffix_array_tpu.bench.micro as jmicro
import hpc_suffix_array_tpu.bench.parse as jparse
import hpc_suffix_array_tpu.bench.timing as jtiming
import hpc_suffix_array_tpu.core.bigsort as jbs
import hpc_suffix_array_tpu.datasets.generate as jgen
import hpc_suffix_array_tpu_torch.bench as tbench
import hpc_suffix_array_tpu_torch.bench.harness as tharness
import hpc_suffix_array_tpu_torch.bench.micro as tmicro
import hpc_suffix_array_tpu_torch.bench.parse as tparse
import hpc_suffix_array_tpu_torch.bench.timing as ttiming
import hpc_suffix_array_tpu_torch.core.bigsort as tbs
import hpc_suffix_array_tpu_torch.datasets.generate as tgen
from hpc_suffix_array_tpu_torch import cli as tcli
from hpc_suffix_array_tpu_torch.core.oracle import (
    lcp_oracle, suffix_array_oracle)

FAMILIES = {
    "random": tgen.generate_random_text,
    "dna": tgen.generate_dna_text,
    "p1000": tgen.generate_repetitive_text,
    "words": tgen.generate_words_text,
}
INT_FIELDS = ("string_length", "lrs_length", "valid", "memory_used",
              "builder")
TINY = dict(target_bucket=1 << 12, chunk_elems=1 << 12, sample=1 << 12)


def _same_integers(j, t):
    for f in INT_FIELDS:
        assert getattr(j, f) == getattr(t, f), f
    assert t.valid is True


# --- run_benchmark --------------------------------------------------------

@pytest.mark.parametrize("log_n", [12, 15])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_benchmark_matches_jax(family, log_n):
    text = FAMILIES[family](1 << log_n, seed=log_n)
    j = jtiming.run_benchmark(text, validate=True, warmup=False)
    t = ttiming.run_benchmark(text, device="cpu", validate=True,
                              warmup=False)
    _same_integers(j, t)
    assert t.builder == "doubling"
    assert t.implementation == "torch_cpu" and t.input_type == "random"
    assert min(t.total_time, t.sa_time, t.lcp_time, t.lrs_time) > 0
    assert t.total_time >= t.sa_time + t.lcp_time + t.lrs_time
    assert t.compile_time == 0.0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_run_benchmark_fused_route_matches_jax(family, monkeypatch):
    """Above a lowered SA_LCP_BIG_MIN both packages run one fused
    carried-keys build: the LCP phase is empty, far below the SA phase."""
    monkeypatch.setenv("SA_LCP_BIG_MIN", "5000")
    monkeypatch.setenv("SA_BIG_THRESHOLD", "5000")
    text = FAMILIES[family](30_000, seed=3)
    j = jtiming.run_benchmark(text, validate=True, warmup=False)
    t = ttiming.run_benchmark(text, device="cpu", validate=True,
                              warmup=False)
    _same_integers(j, t)
    assert t.builder == "direct"
    assert t.sa_time > 0 and 0 <= t.lcp_time < t.sa_time


def test_run_benchmark_warmup_and_staged_text():
    text = tgen.generate_random_text(1 << 12, seed=1)
    staged = torch.from_numpy(text.copy())
    r = ttiming.run_benchmark(text, "label", "twin_device", device="cpu",
                              text_dev=staged)
    assert r.implementation == "label" and r.input_type == "twin_device"
    assert r.valid is None and r.compile_time >= 0.0
    assert r.as_row()["string_length"] == 1 << 12
    assert (list(r.as_row()) == list(jtiming.BenchmarkResult.
                                     __dataclass_fields__))


def test_run_benchmark_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttiming.run_benchmark(b"banana")


# --- micro ----------------------------------------------------------------

def test_micro_header_matches_jax():
    assert tmicro.CSV_HEADER == jmicro.CSV_HEADER
    assert tmicro.SIZES == jmicro.SIZES and tmicro.REPS == jmicro.REPS


def test_micro_benchmark_csv(tmp_path):
    kw = dict(sizes=(1_000, 2_000), reps=1, verbose=False)
    jres = jmicro.run_micro_benchmark(out_csv=tmp_path / "j.csv", **kw)
    tres = tmicro.run_micro_benchmark(out_csv=tmp_path / "t.csv",
                                      device="cpu", **kw)
    with open(tmp_path / "j.csv", newline="") as f:
        jrows = list(csv.reader(f))
    with open(tmp_path / "t.csv", newline="") as f:
        trows = list(csv.reader(f))
    assert trows[0] == jrows[0] == jmicro.CSV_HEADER
    assert len(trows) == len(jrows) == 5
    for jr, tr in zip(jrows[1:], trows[1:]):
        assert tr[0] == "torch_cpu"
        # input_type, string_length, memory_used
        assert (tr[1], tr[2], tr[7]) == (jr[1], jr[2], jr[7])
        assert float(tr[4]) > 0
    assert [r.lrs_length for r in tres] == [r.lrs_length for r in jres]


# --- harness --------------------------------------------------------------

def _read_csv(path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_benchmark_corpora_matches_jax(tmp_path):
    files = tgen.generate_test_fixtures(tmp_path / "data")
    jharness.benchmark_corpora(files, results_dir=tmp_path / "j",
                               verbose=False)
    rows = tharness.benchmark_corpora(files, results_dir=tmp_path / "t",
                                      device="cpu", verbose=False)
    jcols, jrows = _read_csv(tmp_path / "j" / "sequential_results.csv")
    tcols, trows = _read_csv(tmp_path / "t" / "sequential_results.csv")
    assert tcols == jcols
    assert len(trows) == len(jrows) == len(files) == len(rows)
    for jr, tr in zip(jrows, trows):
        for col in ("file", "size_bytes", "lrs_length", "success",
                    "input_mode", "processes", "builder", "error"):
            assert tr[col] == jr[col], col
        assert tr["backend"] == "torch_cpu" and tr["platform"] == "cpu"
        assert float(tr["sa_time"]) > 0 and float(tr["throughput_mb_s"]) > 0
    assert all(r["success"] is True for r in rows)


def test_harness_failed_rows_match_jax(tmp_path):
    """A missing file yields a FAILED row and the sweep continues; the
    columns keep the JAX harness's order even with the FAILED row first."""
    good = tmp_path / "good.txt"
    good.write_bytes(b"mississippi" * 50)
    files = [tmp_path / "missing.txt", good]
    jharness.benchmark_corpora(files, results_dir=tmp_path / "j",
                               verbose=False)
    rows = tharness.benchmark_corpora(files, results_dir=tmp_path / "t",
                                      device="cpu", verbose=False)
    jcols, jrows = _read_csv(tmp_path / "j" / "sequential_results.csv")
    tcols, trows = _read_csv(tmp_path / "t" / "sequential_results.csv")
    assert tcols == jcols and "compile_time" in tcols
    assert [r["file"] for r in trows] == ["missing.txt", "good.txt"]
    for jr, tr in zip(jrows, trows):
        for col in ("file", "size_bytes", "lrs_length", "success",
                    "input_mode", "builder"):
            assert tr[col] == jr[col], col
    assert rows[0]["success"] is False and "read error" in rows[0]["error"]
    assert rows[1]["success"] is True and rows[1]["sa_time"] > 0


def test_harness_timeout_gives_failed_row(tmp_path, monkeypatch):
    """A run past ``timeout_s`` becomes a FAILED row; the next file still
    runs."""
    files = tgen.generate_test_fixtures(tmp_path / "data")[:2]
    real = tharness.run_benchmark

    def slow_on_banana(text, *a, **kw):
        if len(text) == 6:
            end = time.monotonic() + 20
            while time.monotonic() < end:
                time.sleep(0.01)
        return real(text, *a, **kw)

    monkeypatch.setattr(tharness, "run_benchmark", slow_on_banana)
    t0 = time.monotonic()
    rows = tharness.benchmark_corpora(files, results_dir=tmp_path / "r",
                                      device="cpu", verbose=False,
                                      timeout_s=0.3)
    assert time.monotonic() - t0 < 15
    assert [r["success"] for r in rows] == [False, True]
    assert "timeout after 0.3s" in rows[0]["error"]
    assert rows[0]["size_bytes"] == 6 and rows[0]["sa_time"] == 0.0


def test_harness_records_a_failed_build(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("injected for test")

    monkeypatch.setattr(tharness, "run_benchmark", boom)
    good = tmp_path / "good.txt"
    good.write_bytes(b"banana")
    rows = tharness.benchmark_corpora([good], results_dir=tmp_path / "r",
                                      device="cpu", verbose=False)
    assert rows[0]["success"] is False
    assert rows[0]["error"] == "RuntimeError: injected for test"


@pytest.mark.parametrize("family", ["random", "dna", "repetitive", "words"])
def test_twin_mode_parses_the_family(family, tmp_path):
    name = f"{family}_1MB.txt"
    rows = tharness.benchmark_corpora(
        [name], results_dir=tmp_path, device="cpu", verbose=False,
        seq_csv_name="sequential_results_twin.csv", twin=True)
    (row,) = rows
    assert row["success"] is True and row["file"] == name
    assert row["input_mode"] == "twin_device"
    assert row["backend"] == "torch_cpu_twin"
    assert row["size_bytes"] == 1 << 20
    cols, _ = _read_csv(tmp_path / "sequential_results_twin.csv")
    assert cols[-1] == "input_mode"


def test_twin_corpora_are_the_family(tmp_path):
    host, dev = tharness._twin_for_file("somewhere/words_1MB.txt", "cpu")
    assert np.array_equal(host, dev.numpy()) and len(host) == 1 << 20
    assert np.array_equal(host, tgen.generate_words_text_batched(1 << 20, 0))
    host, _ = tharness._twin_for_file("dna_2MB", "cpu")
    assert len(host) == 2 << 20 and set(np.unique(host)) == set(b"ACGT")
    host, _ = tharness._twin_for_file("repetitive_1MB.txt", "cpu")
    assert np.array_equal(host, tgen.generate_repetitive_text(1 << 20, 0))
    host, _ = tharness._twin_for_file("random_1MB.txt", "cpu")
    assert set(np.unique(host)) <= set(tgen.ALNUM)
    assert tharness._twin_for_file("banana.txt", "cpu") is None


def test_twin_mode_falls_back_to_the_file(tmp_path):
    p = tmp_path / "banana.txt"
    p.write_bytes(b"banana")
    (row,) = tharness.benchmark_corpora([p], results_dir=tmp_path / "r",
                                        device="cpu", verbose=False,
                                        twin=True)
    assert row["input_mode"] == "file" and row["backend"] == "torch_cpu"
    assert row["lrs_length"] == 3


def test_bench_exports_match_jax():
    import hpc_suffix_array_tpu.bench as jbench
    import hpc_suffix_array_tpu.utils as jutils
    import hpc_suffix_array_tpu.viz as jviz
    import hpc_suffix_array_tpu_torch.utils as tutils
    import hpc_suffix_array_tpu_torch.viz as tviz

    assert tbench.__all__ == jbench.__all__
    assert tviz.__all__ == jviz.__all__
    assert tutils.__all__ == jutils.__all__


# --- add_speedup_efficiency -----------------------------------------------

def _par_row(file, sa_time, processes, builder=None):
    row = {"file": file, "sa_time": sa_time, "processes": processes,
           "backend": f"x_sharded_{processes}"}
    if builder is not None:
        row["builder"] = builder
    return row


SPEEDUP_CASES = {
    "same_builder": (
        [_par_row("a", 0.5, 2, "sharded_msd"), _par_row("b", 0.25, 4, "msd")],
        [{"file": "a", "sa_time": 1.0, "builder": "msd"},
         {"file": "b", "sa_time": 2.0, "builder": "msd"}]),
    "builder_mismatch": (
        [_par_row("a", 0.5, 2, "sharded_msd"),
         _par_row("b", 0.5, 2, "doubling")],
        [{"file": "a", "sa_time": 1.0, "builder": "doubling"},
         {"file": "b", "sa_time": 1.0, "builder": "doubling"}]),
    "no_builder_columns": (
        [_par_row("a", 0.5, 2)], [{"file": "a", "sa_time": 1.5}]),
    "empty_builders": (
        [_par_row("a", 0.5, 2, ""), _par_row("b", 0.5, 2, "msd")],
        [{"file": "a", "sa_time": 1.0, "builder": "msd"},
         {"file": "b", "sa_time": 1.0, "builder": ""}]),
    "zero_time_and_processes": (
        [_par_row("a", 0.0, 2, "msd"), _par_row("b", 0.5, 0, "msd")],
        [{"file": "a", "sa_time": 1.0, "builder": "msd"},
         {"file": "b", "sa_time": 1.0, "builder": "msd"}]),
    "missing_baseline": (
        [_par_row("zzz", 0.5, 2, "msd")],
        [{"file": "a", "sa_time": 1.0, "builder": "msd"}]),
    "empty_baseline": ([_par_row("a", 0.5, 2, "msd")], []),
}


@pytest.mark.parametrize("case", list(SPEEDUP_CASES))
def test_add_speedup_efficiency_matches_jax(case):
    par, seq = SPEEDUP_CASES[case]
    want = jharness.add_speedup_efficiency(pd.DataFrame(par),
                                           pd.DataFrame(seq))
    got = tharness.add_speedup_efficiency(par, seq)
    assert len(got) == len(want)
    for (_, w), g in zip(want.iterrows(), got):
        for col in ("speedup", "efficiency"):
            assert g[col] == w[col], col
        assert g["baseline_builder"] == w["baseline_builder"]
        assert g["builder_mismatch"] == bool(w["builder_mismatch"])
    assert "speedup" not in par[0]          # the input rows are not edited


# --- parse ----------------------------------------------------------------

@pytest.mark.parametrize("dialect", ["sequential", "mpi", "both"])
def test_parse_port_cli_output_matches_jax(dialect, capsys):
    assert tcli.main(["banana", "--device", "cpu", "--dialect",
                      dialect]) == 0
    out = capsys.readouterr().out
    rec = tparse.parse_structured_results(out)
    assert rec == jparse.parse_structured_results(out)
    both = tparse.parse_all_structured_results(out)
    assert both == jparse.parse_all_structured_results(out)
    assert len(both) == (2 if dialect == "both" else 1)
    assert rec["dialect"] == ("mpi" if dialect == "mpi" else "sequential")
    assert rec["sa_time"] > 0 and rec["total_time"] > 0
    if dialect == "mpi":
        assert rec["actual_string_length"] == 6
    else:
        assert rec["file_size"] == 6 and rec["path"] == "doubling"
        assert rec["implementation"] == "torch_cpu"


def test_parse_path_rerun_and_failed_blocks():
    text = ("noise\n===STRUCTURED_RESULTS===\nIMPLEMENTATION:cuda\n"
            "FILENAME:a/b.txt\nFILE_SIZE:1073741824\nTOTAL_TIME:0.750000\n"
            "SA_TIME:0.700000\nLCP_TIME:0.050000\nPROCESSES:1\nPATH:msd\n"
            "RERUN:chain_to_ascending,ascending_to_chain\n"
            "===END_RESULTS===\n")
    rec = tparse.parse_structured_results(text)
    assert rec == jparse.parse_structured_results(text)
    assert rec["path"] == "msd" and rec["file_size"] == 1 << 30
    assert rec["rerun"] == "chain_to_ascending,ascending_to_chain"
    failed = ("===STRUCTURED_RESULTS===\nIMPLEMENTATION:cuda\nFILENAME:x\n"
              "FILE_SIZE:6\nSTATUS:FAILED\nERROR:RuntimeError\n"
              "===END_RESULTS===")
    rec = tparse.parse_structured_results(failed)
    assert rec == jparse.parse_structured_results(failed)
    assert rec["status"] == "FAILED" and rec["error"] == "RuntimeError"
    assert tparse.parse_structured_results("no block here") == {}
    assert tparse.parse_all_structured_results("no block here") == []


def test_parse_file_run_of_the_cli(tmp_path, capsys):
    (path,) = tgen.generate_standard_datasets(
        tmp_path, random_mb=(1,), repetitive_mb=(), dna_mb=())
    assert tcli.main([str(path), "--device", "cpu", "--no-validate"]) == 0
    rec = tparse.parse_structured_results(capsys.readouterr().out)
    assert rec["file_size"] == 1 << 20 and rec["filename"] == str(path)
    assert rec["path"] == "doubling"


# --- generators -----------------------------------------------------------

def _meta(path):
    meta = json.loads(path.with_suffix(path.suffix + ".meta").read_text())
    meta.pop("generated")
    return meta


def _same_files(jfiles, tfiles):
    assert [p.name for p in tfiles] == [p.name for p in jfiles]
    for jp, tp in zip(jfiles, tfiles):
        assert tp.read_bytes() == jp.read_bytes()
        assert _meta(tp) == _meta(jp)
        assert _meta(tp)["md5"] == hashlib.md5(tp.read_bytes()).hexdigest()


def _assert_idempotent(make, files):
    mtimes = {p: p.stat().st_mtime_ns for p in files}
    again = make()
    assert again == files
    assert {p: p.stat().st_mtime_ns for p in again} == mtimes


def test_fixture_files_match_jax(tmp_path):
    jfiles = jgen.generate_test_fixtures(tmp_path / "j")
    tfiles = tgen.generate_test_fixtures(tmp_path / "t")
    _same_files(jfiles, tfiles)
    assert tgen.SMALL_FIXTURES == jgen.SMALL_FIXTURES
    _assert_idempotent(lambda: tgen.generate_test_fixtures(tmp_path / "t"),
                       tfiles)


def test_standard_dataset_files_match_jax(tmp_path):
    kw = dict(random_mb=(1, 2), repetitive_mb=(1,), dna_mb=(1,), seed=7)
    jfiles = jgen.generate_standard_datasets(tmp_path / "j", **kw)
    tfiles = tgen.generate_standard_datasets(tmp_path / "t", **kw)
    _same_files(jfiles, tfiles)
    assert [p.name for p in tfiles] == [
        "random_1MB.txt", "random_2MB.txt", "repetitive_1MB.txt",
        "dna_1MB.txt"]
    _assert_idempotent(
        lambda: tgen.generate_standard_datasets(tmp_path / "t", **kw), tfiles)


@pytest.mark.parametrize("make,alphabet", [
    (tgen.device_random_text, tgen.ALNUM), (tgen.device_dna_text, tgen.DNA)])
def test_device_generators_on_the_cpu(make, alphabet):
    a = make(100_000, 5, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (100_000,)
    assert set(np.unique(a.numpy())) == set(alphabet)
    assert torch.equal(a, make(100_000, 5, "cpu"))
    assert not torch.equal(a, make(100_000, 6, "cpu"))


def test_device_repetitive_text_equals_the_host_generator():
    for n in (999, 1000, 12_345):
        assert np.array_equal(
            tgen.device_repetitive_text(n, 4, "cpu").numpy(),
            tgen.generate_repetitive_text(n, 4))


def test_batched_words_text_is_pinned():
    """The bytes the card measurements were taken on: the first 64 and
    the MD5 of 2^20 bytes for seed 0."""
    w = tgen.generate_words_text_batched(1 << 20, 0)
    assert w[:64].tobytes() == (b"UMvC6O UMvC6O 78Ernr9wu abb9X8F jjnlY6Fr "
                                b"HqkAUi ksxRtE4v 2D0N 0C")
    assert hashlib.md5(w.tobytes()).hexdigest() == (
        "4e0a0ff9b1e0d19a293c6e2ed7507352")
    small = tgen.generate_words_text_batched(50_000, 0, batch=1 << 10)
    assert len(small) == 50_000 and set(np.unique(small)) <= (
        set(tgen.ALNUM) | {ord(" ")})


def test_words_text_still_matches_jax():
    for n, seed in ((1000, 0), (300_000, 3)):
        assert np.array_equal(tgen.generate_words_text(n, seed),
                              jgen.generate_words_text(n, seed))


# --- replan_edges ---------------------------------------------------------

REPLAN_CORPORA = {
    "alnum": lambda: tgen.ALNUM[np.random.default_rng(2).integers(
        0, 62, 40_000)],
    "dna": lambda: tgen.DNA[np.random.default_rng(3).integers(0, 4, 40_000)],
    "bytes": lambda: np.random.default_rng(1).integers(
        0, 256, 40_000).astype(np.uint8),
    "short_tail": lambda: tgen.ALNUM[np.random.default_rng(5).integers(
        0, 62, 20_011)],
}


@pytest.mark.parametrize("name", list(REPLAN_CORPORA))
def test_replan_edges_device_sampler_matches_jax(name, monkeypatch):
    monkeypatch.setenv("SA_BIG_COUNT_FREE", "0")
    text = REPLAN_CORPORA[name]()
    jstate = jbs.prepare_big(text, **TINY)
    tstate = tbs.prepare_big(text, device="cpu", **TINY)
    assert not tstate["plan"].e1.any() and jstate.get("ranges") is not None
    before = tstate["plan"].e0.copy()
    jbs.replan_edges(jstate)
    tbs.replan_edges(tstate)
    e0 = tstate["plan"].e0
    assert e0.dtype == np.int32
    assert np.array_equal(e0, np.asarray(jstate["plan"].e0))
    assert len(e0) == len(before) and not np.array_equal(e0, before)
    sa, lcp = tbs.execute_big(tstate, want_lcp=True)
    want = suffix_array_oracle(text)
    assert np.array_equal(sa.numpy(), want)
    assert np.array_equal(lcp.numpy(), lcp_oracle(text, want))


def test_replan_edges_pair_edges_use_the_host_sampler(monkeypatch):
    monkeypatch.setenv("SA_BIG_COUNT_FREE", "0")
    text = np.concatenate([
        np.full(20_000, ord("a"), np.uint8),
        np.random.default_rng(1).integers(97, 123, 20_000).astype(np.uint8)])
    jstate = jbs.prepare_big(text, **TINY)
    tstate = tbs.prepare_big(text, device="cpu", **TINY)
    assert tstate["plan"].e1.any()
    jbs.replan_edges(jstate, text)
    tbs.replan_edges(tstate)
    assert np.array_equal(tstate["plan"].e0, jstate["plan"].e0)
    assert np.array_equal(tstate["plan"].e1, jstate["plan"].e1)
    sa = tbs.execute_big(tstate)
    assert np.array_equal(sa.numpy(), suffix_array_oracle(text))


def test_sample_k0_device_on_a_text_shorter_than_one_stride():
    text = np.frombuffer(b"ACGTACGTAC", np.uint8)
    tstate = tbs.prepare_big(text, device="cpu", target_bucket=4,
                             chunk_elems=4)
    assert not tstate["plan"].e1.any()
    tbs.replan_edges(tstate)
    sa = tbs.execute_big(tstate)
    assert np.array_equal(sa.numpy(), suffix_array_oracle(text))


# --- the sharded rows -------------------------------------------------------

def test_benchmark_corpora_mesh_sizes_match_jax(tmp_path):
    """Integer mesh sizes add sharded rows (``<platform>_sharded_P``) and
    parallel_results.csv with speedup and efficiency against the same
    run's single-device rows, in the JAX harness's columns."""
    files = tgen.generate_test_fixtures(tmp_path / "data")[:3]
    jharness.benchmark_corpora(files, results_dir=tmp_path / "j",
                               mesh_sizes=(None, 2), verbose=False)
    rows = tharness.benchmark_corpora(files, results_dir=tmp_path / "t",
                                      device="cpu", mesh_sizes=(None, 2),
                                      verbose=False)
    assert [r["backend"] for r in rows] == (["torch_cpu"] * 3
                                            + ["cpu_sharded_2"] * 3)
    jcols, jrows = _read_csv(tmp_path / "j" / "parallel_results.csv")
    tcols, trows = _read_csv(tmp_path / "t" / "parallel_results.csv")
    assert tcols == jcols
    assert len(trows) == len(jrows) == 3
    for jr, tr in zip(jrows, trows):
        for col in ("file", "size_bytes", "lrs_length", "success",
                    "input_mode", "processes", "backend", "platform",
                    "builder", "baseline_builder", "builder_mismatch"):
            assert tr[col] == jr[col], col
        assert float(tr["speedup"]) > 0
        assert float(tr["efficiency"]) == float(tr["speedup"]) / 2
    _, seq = _read_csv(tmp_path / "t" / "sequential_results.csv")
    assert [r["backend"] for r in seq] == ["torch_cpu"] * 3


def test_run_benchmark_sharded_matches_single(monkeypatch):
    """From SA_SHARDED_MSD_MIN up the sharded pipeline times the fused
    build_sa_lcp_sharded in its SA phase; below it, the split builders."""
    import hpc_suffix_array_tpu_torch.parallel as tpar

    fused = []
    real = tpar.build_sa_lcp_sharded
    monkeypatch.setattr(tpar, "build_sa_lcp_sharded",
                        lambda *a, **k: fused.append(1) or real(*a, **k))
    text = tgen.generate_dna_text(1 << 13, seed=3)
    single = ttiming.run_benchmark(text, device="cpu", validate=True,
                                   warmup=False)
    mesh = tpar.make_mesh(4, devices=["cpu"])
    # At SA_SHARDED_MSD_MIN the fused router takes the carried keys, as
    # the JAX package's does; one byte above the minimum, doubling.
    for msd_min, calls, builder in ((str(1 << 13), 1, "sharded_msd"),
                                    (str((1 << 13) + 1), 1,
                                     "sharded_doubling")):
        monkeypatch.setenv("SA_SHARDED_MSD_MIN", msd_min)
        r = ttiming.run_benchmark(text, validate=True, warmup=False,
                                  mesh=mesh)
        assert (r.implementation, r.builder, r.valid) == (
            "torch_cpu_sharded", builder, True)
        assert r.lrs_length == single.lrs_length
        assert len(fused) == calls


def test_mesh_sweep_writes_both_csvs(tmp_path):
    """The sweep reads a corpus file that is already there (here a small
    one under the 1 MB name) and writes one only where it is missing."""
    from hpc_suffix_array_tpu_torch.bench import mesh_sweep

    data = tmp_path / "data"
    data.mkdir()
    small = tgen.generate_random_text(1 << 12, seed=42)
    (data / "random_1MB.txt").write_bytes(small.tobytes())
    rows = mesh_sweep.main(sizes_mb=(1,), out_dir=tmp_path / "out",
                           data_dir=tmp_path / "data", mesh_sizes=(None, 2),
                           device="cpu", families=("random",),
                           charts=False, verbose=False)
    assert [(r["backend"], r["success"], r["size_bytes"]) for r in rows] == [
        ("torch_cpu", True, 1 << 12), ("cpu_sharded_2", True, 1 << 12)]
    _, seq = _read_csv(tmp_path / "out" / "sequential_results_cpu.csv")
    _, par = _read_csv(tmp_path / "out" / "parallel_results.csv")
    assert len(seq) == len(par) == 1
    assert par[0]["builder_mismatch"] == "False"      # doubling both
    report = tmp_path / "out" / "charts" / "multi_backend_report.txt"
    assert "[cpu_sharded_2]" in report.read_text()
