"""The port's charts and reports on synthetic sweep CSVs.

The four cases of ``tests/test_viz.py`` on the port's ``viz`` (which
reads CSVs with the ``csv`` module), and the text reports held against
the JAX package's on the same CSV: every line equal apart from the title
and the ``generated:`` timestamp (tolerance: none, the numbers are
formatted text).
"""

import numpy as np
import pandas as pd
import pytest

import hpc_suffix_array_tpu.viz as jviz
import hpc_suffix_array_tpu_torch.viz as tviz
from hpc_suffix_array_tpu_torch.bench.harness import (
    _failed_row, _write_rows)
from hpc_suffix_array_tpu_torch.viz.report import read_rows


def _frame(backend="tpu", seed=3, scale=1.0):
    rng = np.random.default_rng(seed)
    sizes = np.array([1 << 14, 1 << 16, 1 << 18, 1 << 20])
    sa = scale * (sizes * 2e-8 + rng.uniform(0, 1e-4, len(sizes)))
    lcp = sizes * 1e-8
    lrs = np.full(len(sizes), 2e-4)
    return pd.DataFrame({
        "file": [f"f{i}.txt" for i in range(len(sizes))],
        "size_bytes": sizes,
        "size_mb": sizes / (1 << 20),
        "backend": backend,
        "processes": 1,
        "time_seconds": sa + lcp + lrs,
        "throughput_mb_s": sizes / (1 << 20) / (sa + lcp + lrs),
        "throughput_chars_per_second": sizes / (sa + lcp + lrs),
        "lrs_length": 12,
        "total_time": sa + lcp + lrs,
        "sa_time": sa,
        "lcp_time": lcp,
        "lrs_time": lrs,
        "compile_time": 0.5,
        "success": True,
        "error": "",
    })


@pytest.fixture()
def seq_csv(tmp_path):
    p = tmp_path / "sequential_results.csv"
    _frame().to_csv(p, index=False)
    return p


def test_performance_charts(seq_csv, tmp_path):
    paths = tviz.generate_performance_charts(seq_csv, tmp_path / "charts")
    assert len(paths) == 1 and paths[0].exists()
    assert paths[0].name == "performance_analysis.png"
    assert paths[0].stat().st_size > 1000


def test_phase_breakdown_chart(seq_csv, tmp_path):
    paths = tviz.generate_phase_breakdown_chart(seq_csv, tmp_path / "charts")
    assert len(paths) == 1 and paths[0].exists()
    assert paths[0].name == "phase_breakdown.png"
    assert paths[0].stat().st_size > 1000


def test_phase_breakdown_skips_failed_rows(seq_csv, tmp_path):
    df = pd.read_csv(seq_csv)
    df.loc[len(df)] = df.iloc[-1]
    df.loc[len(df) - 1, ["success", "sa_time"]] = [False, 0.0]
    df.to_csv(seq_csv, index=False)
    rows = read_rows(seq_csv)
    assert [r["success"] for r in rows] == [True] * 4 + [False]
    paths = tviz.generate_phase_breakdown_chart(seq_csv, tmp_path / "charts")
    assert len(paths) == 1
    _write_rows(seq_csv, [_failed_row("x", 0, "cuda", 1, "read error", "cuda")])
    assert tviz.generate_phase_breakdown_chart(seq_csv, tmp_path / "c") == []


def test_statistics_report(seq_csv, tmp_path):
    out = tviz.generate_statistics_report(seq_csv, tmp_path / "stats.txt")
    text = out.read_text()
    assert "STATISTICS" in text and "exponent" in text


def _body(path):
    """A report's lines apart from the title and the timestamp."""
    lines = path.read_text().splitlines()
    assert lines[1] == "=" * 60 and lines[2].startswith("generated: ")
    return [ln for ln in lines[3:] if ln]


def test_statistics_report_equals_jax(seq_csv, tmp_path):
    t = tviz.generate_statistics_report(seq_csv, tmp_path / "t.txt")
    j = jviz.generate_statistics_report(seq_csv, tmp_path / "j.txt")
    assert _body(t) == _body(j)
    assert len(_body(t)) == 11


def test_statistics_report_on_the_ports_own_csv_equals_jax(tmp_path):
    """A CSV the port's harness wrote reads the same through both
    packages."""
    from hpc_suffix_array_tpu_torch.bench.harness import benchmark_corpora
    from hpc_suffix_array_tpu_torch.datasets import generate_test_fixtures

    files = generate_test_fixtures(tmp_path / "data")
    benchmark_corpora(files, results_dir=tmp_path, device="cpu",
                      verbose=False)
    csv_path = tmp_path / "sequential_results.csv"
    t = tviz.generate_statistics_report(csv_path, tmp_path / "t.txt")
    j = jviz.generate_statistics_report(csv_path, tmp_path / "j.txt")
    assert _body(t) == _body(j)
    assert tviz.generate_phase_breakdown_chart(csv_path, tmp_path / "c")


def test_statistics_report_keeps_failed_rows_out_of_the_fit(tmp_path):
    """A FAILED row first (size 0, columns it lacks left empty): the
    report lists it and fits the rows that ran."""
    from hpc_suffix_array_tpu_torch.bench.harness import benchmark_corpora
    from hpc_suffix_array_tpu_torch.datasets import generate_test_fixtures

    files = generate_test_fixtures(tmp_path / "data")
    benchmark_corpora([tmp_path / "missing.txt", *files],
                      results_dir=tmp_path, device="cpu", verbose=False)
    csv_path = tmp_path / "sequential_results.csv"
    text = tviz.generate_statistics_report(
        csv_path, tmp_path / "t.txt").read_text()
    assert "runs:      6" in text and "fitted exponent" in text
    assert "input sizes: 0 .. 1000 bytes" in text
    assert "  missing.txt" in text
    assert tviz.generate_phase_breakdown_chart(csv_path, tmp_path / "c")
    assert tviz.generate_performance_charts(csv_path, tmp_path / "c")


def test_multi_backend_report_equals_jax(tmp_path):
    rd = tmp_path / "results"
    rd.mkdir()
    _frame("cuda").to_csv(rd / "sequential_results.csv", index=False)
    _frame("cuda_twin", seed=4, scale=0.5).to_csv(
        rd / "sequential_results_twin.csv", index=False)
    par = _frame("cuda_sharded_2", seed=5, scale=0.6)
    par["speedup"] = [1.5, 1.6, np.nan, 1.8]
    par["efficiency"] = par["speedup"] / 2
    par["builder_mismatch"] = [False, False, False, True]
    par.to_csv(rd / "parallel_results.csv", index=False)
    t = tviz.generate_multi_backend_report(rd, tmp_path / "t.txt")
    j = jviz.generate_multi_backend_report(rd, tmp_path / "j.txt")
    assert _body(t) == _body(j)
    text = t.read_text()
    assert "[cuda_twin]" in text and "mean speedup" in text
    paths = tviz.generate_comparative_charts(rd, tmp_path / "charts")
    assert len(paths) == 1 and paths[0].stat().st_size > 1000


def test_reports_and_charts_without_results(tmp_path):
    (tmp_path / "empty").mkdir()
    t = tviz.generate_multi_backend_report(tmp_path / "empty",
                                           tmp_path / "t.txt")
    j = jviz.generate_multi_backend_report(tmp_path / "empty",
                                           tmp_path / "j.txt")
    assert _body(t) == _body(j) == ["no results found"]
    assert tviz.generate_comparative_charts(tmp_path / "empty",
                                            tmp_path / "c") == []
