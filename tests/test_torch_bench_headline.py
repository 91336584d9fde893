"""The port's headline benchmark (``bench_cuda.py``,
``hpc_suffix_array_tpu_torch/bench/headline.py``) against ``bench.py``:
the same corpus bytes, JSON keys and metric names, and SAs equal to
SA-IS and the JAX package's on the routes it times. Here on the CPU."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu as jsa
from hpc_suffix_array_tpu_torch import native
from hpc_suffix_array_tpu_torch.bench import headline
from hpc_suffix_array_tpu_torch.datasets import (
    device_random_text, device_words_text, generate_words_text_batched)
from hpc_suffix_array_tpu_torch.datasets.generate import _word_table

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = 1 << 16
# What bench.py prints on stderr at SMALL bytes (every corpus on the
# doubling builder; sa_lcp_build only follows a carried-keys headline).
SECONDARY_AT_SMALL = ("sa_build_dna", "sa_build_repetitive_p1000",
                      "sa_build_words", "lcp_build",
                      "lcp_build_sorted_fetch")
MEASURE_N = 1 << 18
# env of each route measure() times at MEASURE_N, and bench.py's label.
ROUTES = {
    "doubling": ({}, "doubling"),
    "direct": ({"SA_BIG_THRESHOLD": "65536"}, "direct_sort"),
    "msd": ({"SA_BIG_THRESHOLD": "65536", "SA_DIRECT_CROSS": "0",
             "SA_CHUNK_ELEMS": str(1 << 16),
             "SA_TARGET_BUCKET": str(1 << 14)}, "msd_bigsort"),
}


def _bench_py():
    sys.path.insert(0, str(REPO))
    try:
        import bench
    finally:
        sys.path.pop(0)
    return bench


def _run(args, **env):
    return subprocess.run(
        [sys.executable, str(REPO / "bench_cuda.py"), *args],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, **env))


def _stderr_metrics(text: str) -> dict:
    recs = (json.loads(line) for line in text.splitlines()
            if line.startswith("{"))
    return {r["metric"]: r for r in recs}


@pytest.mark.parametrize("n", [SMALL, (1 << 24) + 3])
def test_bench_text_matches_bench_py(n):
    want = _bench_py()._bench_text(n)
    got = headline.bench_text(n)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()


def test_headline_line_on_cpu():
    out = _run(["--device", "cpu"], SA_BENCH_BYTES=str(SMALL),
               SA_BENCH_REPS="1", SA_BENCH_SECONDARY="0",
               SA_BENCH_BASELINE_BYTES=str(SMALL))
    assert out.returncode == 0, out.stderr[-800:]
    lines = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(lines) == 1, out.stdout
    rec = json.loads(lines[0])
    # tests/test_bench_contract.py's keys, plus the named baseline.
    assert {"metric", "value", "unit", "vs_baseline"} <= set(rec)
    assert {"n", "corpus", "rounds"} <= set(rec)
    assert rec["metric"] == "suffix_array_build_throughput"
    assert rec["n"] == SMALL and "oom_fallback" not in rec
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["unit"] == "MB/s/chip"
    assert rec["baseline"] == "host_sais"
    assert rec["corpus"] == "random_alnum" and rec["rounds"] > 0
    assert "path" not in rec            # bench.py omits the doubling path
    assert out.stderr.splitlines()[0] == "# card: cpu"


def test_secondary_metrics_on_cpu():
    out = _run(["--device", "cpu"], SA_BENCH_BYTES=str(SMALL),
               SA_BENCH_REPS="1", SA_BENCH_SECONDARY="1",
               SA_BENCH_BASELINE_BYTES=str(SMALL))
    assert out.returncode == 0, out.stderr[-800:]
    assert len([l for l in out.stdout.splitlines() if l.strip()]) == 1
    recs = _stderr_metrics(out.stderr)
    assert set(SECONDARY_AT_SMALL) <= set(recs), out.stderr[-800:]
    for metric in SECONDARY_AT_SMALL:
        assert recs[metric]["value"] > 0
        assert recs[metric]["n"] == SMALL
        assert recs[metric]["unit"] == "MB/s/chip"
    for metric in SECONDARY_AT_SMALL[:3]:
        assert recs[metric]["rounds"] > 0
    assert recs["lcp_build"]["path"] == "build_lcp_array_routing"
    assert recs["lcp_build_sorted_fetch"]["path"] == "sorted_fetch_standalone"


@pytest.fixture(scope="module")
def measured_text():
    """The corpus measure() makes at MEASURE_N, with its SA by SA-IS and
    by the JAX package (on its default routes)."""
    arr = device_random_text(MEASURE_N, headline.SEED, "cpu").numpy()
    return arr, native.sa_build(arr), np.asarray(jsa.build_suffix_array(arr))


@pytest.mark.parametrize("route", list(ROUTES))
def test_measure_route_matches_sais_and_jax(route, measured_text,
                                            monkeypatch):
    env, label = ROUTES[route]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    secs, info = headline.measure(MEASURE_N, 1, device="cpu", keep_sa=True)
    arr, sais, jax_sa = measured_text
    assert secs > 0 and info["path"] == label
    sa = info["sa"].numpy()
    np.testing.assert_array_equal(sa, sais)
    np.testing.assert_array_equal(sa, jax_sa)
    if route == "doubling":
        assert info["rounds"] > 0 and "sa_lcp_secs" not in info
    else:
        assert info["sa_lcp_secs"] > 0
    if route == "msd":
        assert info["buckets"] > 1


def test_measure_sa_lcp_off(monkeypatch):
    monkeypatch.setenv("SA_BIG_THRESHOLD", "65536")
    monkeypatch.setenv("SA_BENCH_LCP_BIG", "0")
    _, info = headline.measure(MEASURE_N, 1, device="cpu")
    assert info == {"path": "direct_sort"}


def test_secondary_routes_and_keys(monkeypatch):
    """With the carried-keys thresholds lowered, each corpus takes the
    route the package's gates pick, under bench.py's labels; words
    refine on the device (host residue capped at 8 members)."""
    monkeypatch.setenv("SA_BIG_THRESHOLD", "65536")
    monkeypatch.setenv("SA_LCP_BIG_MIN", "65536")
    monkeypatch.setenv("SA_HOST_RESIDUE_MAX", "8")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        headline.secondary(1 << 17, torch.device("cpu"))
    recs = _stderr_metrics(err.getvalue())
    assert recs["sa_build_dna"]["path"] == "direct_sort"
    # DNA packs 15 symbols a word (minpad), so two words suffice.
    assert "carried_words" not in recs["sa_build_dna"]
    assert recs["sa_build_repetitive_p1000"]["path"] == "direct_chain"
    assert recs["sa_build_words"]["path"] == "direct_sort"
    assert recs["sa_build_words"]["refine_members"] > 0
    assert recs["lcp_build"]["lcp_path"] == "direct"
    monkeypatch.setenv("SA_DIRECT_MAX", "0")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        headline.secondary(1 << 17, torch.device("cpu"))
    recs = _stderr_metrics(err.getvalue())
    assert recs["sa_build_dna"]["path"] == "msd_bigsort"
    assert recs["sa_build_repetitive_p1000"]["path"] == "msd_chain"
    assert recs["sa_build_words"]["path"] == "msd_bigsort"
    assert recs["sa_build_words"]["refine_members"] > 0
    assert recs["lcp_build"]["lcp_path"] == "msd"


def test_is_oom_matches_torch_wording_only():
    """As narrow as bench.py's (tests/test_bench_contract.py), in torch's
    wording: allocator exhaustion halves n, other errors re-raise."""
    assert headline._is_oom(MemoryError("host"))
    assert headline._is_oom(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 8.00 GiB"))
    assert headline._is_oom(RuntimeError(
        "CUDA out of memory. Tried to allocate 2.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)"))
    assert not headline._is_oom(ValueError("bad memory layout for operand"))
    assert not headline._is_oom(RuntimeError("Allocation tracker mismatch"))
    assert not headline._is_oom(RuntimeError("OOM score adjusted"))
    assert not headline._is_oom(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))


def _main_on_cpu(monkeypatch, measure):
    monkeypatch.setenv("SA_BENCH_BYTES", str(1 << 18))
    monkeypatch.setenv("SA_BENCH_BASELINE_BYTES", str(SMALL))
    monkeypatch.setenv("SA_BENCH_SECONDARY", "0")
    monkeypatch.setattr(headline, "measure", measure)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = headline.main(["--device", "cpu"])
    return rc, json.loads(out.getvalue())


def test_oom_halves_n_and_records_it(monkeypatch):
    sizes = []

    def measure(n, reps, *, device):
        sizes.append(n)
        if n > SMALL:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried "
                                              "to allocate 1.00 GiB")
        return 0.01, {"path": "doubling", "rounds": 2}

    rc, line = _main_on_cpu(monkeypatch, measure)
    assert rc == 0 and sizes == [1 << 18, 1 << 17, SMALL]
    assert line["n"] == SMALL and line["requested_bytes"] == 1 << 18
    assert line["oom_fallback"] is True and line["rounds"] == 2


def test_other_errors_are_not_halved(monkeypatch):
    def measure(n, reps, *, device):
        raise RuntimeError("bad memory layout for operand")

    with pytest.raises(RuntimeError, match="bad memory layout"):
        _main_on_cpu(monkeypatch, measure)


def test_secondary_error_propagates(monkeypatch):
    """bench.py swallows a secondary metric's error; the port raises."""
    def broken(nl, dev):
        raise ValueError("lcp route broke")

    monkeypatch.setattr(headline, "_lcp_metrics", broken)
    monkeypatch.setenv("SA_BENCH_BYTES", str(SMALL))
    monkeypatch.setenv("SA_BENCH_REPS", "1")
    monkeypatch.setenv("SA_BENCH_BASELINE_BYTES", str(SMALL))
    with contextlib.redirect_stderr(io.StringIO()), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        with pytest.raises(ValueError, match="lcp route broke"):
            headline.main(["--device", "cpu"])
    assert out.getvalue() == ""            # no result line


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    out = _run([], SA_BENCH_BYTES=str(SMALL))
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_device_words_text_is_the_words_family():
    """The device words draw has the host generator's vocabulary and
    byte frequencies, is n bytes long and fixed by its seed."""
    n = 1 << 20
    got = device_words_text(n, 7, "cpu").numpy()
    host = generate_words_text_batched(n, seed=7, batch=1 << 18)
    assert got.shape == (n,) and got.dtype == np.uint8
    assert np.array_equal(got, device_words_text(n, 7, "cpu").numpy())
    tab, cells = _word_table(np.random.default_rng(7), 1 << 14)
    vocab = {bytes(row[:c - 1]) for row, c in zip(tab, cells)}
    assert set(got.tobytes().split()[:-1]) <= vocab
    freq = np.bincount(got, minlength=256) / n
    want = np.bincount(host, minlength=256) / n
    assert np.abs(freq - want).max() < 2e-3
    for m in (0, 1, 2, 5, 1000):
        assert device_words_text(m, 7, "cpu").shape == (m,)
