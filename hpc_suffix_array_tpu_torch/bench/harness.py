"""Corpus benchmark harness: file sweep, CSVs, speedup/efficiency.

Counterpart of ``hpc_suffix_array_tpu/bench/harness.py`` for one device:
the same row schema, CSV columns in the same order and file names, so
the charts and reports of either package read the other's CSVs. Rows are
dicts and the CSVs are written with the ``csv`` module: the harness needs
neither pandas nor matplotlib.

The harness calls the library in-process and gets structured results
directly; the STRUCTURED_RESULTS text protocol still exists at the CLI
boundary for external consumers (``bench/parse.py``).

Integer mesh sizes run the sharded backend (``parallel/``) and write
``parallel_results.csv`` with speedup and efficiency against the same
run's single-device rows. The weak-scaling sweeps are not here yet.
"""

from __future__ import annotations

import contextlib
import csv
import os
import pathlib
import re
import signal
import threading
import time
from datetime import datetime

import torch

from hpc_suffix_array_tpu_torch.bench.timing import run_benchmark
from hpc_suffix_array_tpu_torch.cli import implementation_name
from hpc_suffix_array_tpu_torch.device import resolve_device
from hpc_suffix_array_tpu_torch.utils.io import read_file

MB = 1024 * 1024
TWIN_NAME = re.compile(r"(random|repetitive|dna|words)_(\d+)MB")


def _row_for_file(path, result, backend: str, processes: int,
                  platform: str) -> dict:
    size = result.string_length
    t = result.total_time
    return {
        "file": os.path.basename(str(path)),
        "size_bytes": size,
        "size_mb": size / MB,
        "backend": backend,
        "platform": platform,
        "processes": processes,
        "time_seconds": t,
        "throughput_mb_s": (size / MB) / t if t > 0 else 0,
        "throughput_chars_per_second": size / t if t > 0 else 0,
        "lrs_length": result.lrs_length,
        "total_time": result.total_time,
        "sa_time": result.sa_time,
        "lcp_time": result.lcp_time,
        "lrs_time": result.lrs_time,
        "compile_time": result.compile_time,
        "builder": result.builder,
        "success": True,
        "error": "",
        "timestamp": datetime.now(),
    }


def _failed_row(path, size_bytes: int, backend: str, processes: int,
                error: str, platform: str) -> dict:
    """FAILED row: the sweep records the failure and continues."""
    return {
        "file": os.path.basename(str(path)),
        "size_bytes": size_bytes,
        "size_mb": size_bytes / MB,
        "backend": backend,
        "platform": platform,
        "processes": processes,
        "time_seconds": 0.0,
        "throughput_mb_s": 0.0,
        "throughput_chars_per_second": 0.0,
        "lrs_length": 0,
        "total_time": 0.0,
        "sa_time": 0.0,
        "lcp_time": 0.0,
        "lrs_time": 0.0,
        "compile_time": 0.0,
        "success": False,
        "error": error[:500],
        "timestamp": datetime.now(),
    }


class _PhaseTimeout(Exception):
    pass


@contextlib.contextmanager
def _time_limit(seconds):
    """Best-effort per-run timeout via SIGALRM (main thread only). The
    signal is handled between Python bytecodes: it cannot interrupt a
    running kernel or a blocked ``synchronize``, so a hung device call
    is not preempted. It catches a pathologically slow corpus between
    launches and host-side loops."""
    if not seconds or threading.current_thread() is not threading.main_thread():
        yield
        return

    def _raise(signum, frame):
        raise _PhaseTimeout(f"timeout after {seconds}s")

    old = signal.signal(signal.SIGALRM, _raise)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _twin_for_file(path, device):
    """Device-born twin of a generated-family corpus file, or None.

    Parses ``{random,repetitive,dna,words}_{N}MB`` from the filename and
    makes a corpus of that family and size on ``device``
    (``datasets.generate.device_*``; words on the host, in batches);
    returns (host bytes, staged device tensor). The bytes are
    family-equivalent, not the file's: twin rows measure the build, not
    the reading and staging of a file. The routers plan on the host
    bytes, so the corpus is copied to the host once, outside any timed
    region."""
    from hpc_suffix_array_tpu_torch.datasets.generate import (
        device_dna_text, device_random_text, device_repetitive_text,
        generate_words_text_batched)

    m = TWIN_NAME.match(os.path.basename(str(path)))
    if m is None:
        return None
    fam, n = m.group(1), int(m.group(2)) * MB
    if fam == "words":
        text = generate_words_text_batched(n, seed=0)
        return text, torch.from_numpy(text).to(device)
    make = {"random": device_random_text, "dna": device_dna_text,
            "repetitive": device_repetitive_text}[fam]
    text_dev = make(n, 0, device)
    return text_dev.cpu().numpy(), text_dev


def _write_rows(path, rows: list[dict]) -> None:
    """Rows as a CSV whose columns are the keys in order of first
    appearance; a key a row lacks is left empty."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=columns, restval="")
        w.writeheader()
        w.writerows(rows)


def benchmark_corpora(files, results_dir="results/benchmarks",
                      device="cuda", verbose: bool = True,
                      timeout_s: float | None = 7200,
                      seq_csv_name: str = "sequential_results.csv",
                      twin: bool = False, mesh_sizes=(None,)) -> list[dict]:
    """Sweep corpus files on ``device``; write the CSVs; return the rows.

    ``mesh_sizes``: None (one device) and/or integers P, each a sweep of
    the sharded backend over ``make_mesh(P, device=device)`` (P shards,
    shard i on card i mod the card count), with rows labelled
    ``<platform>_sharded_P`` and ``processes`` P. Single-device rows go
    to ``seq_csv_name``; sharded rows, with ``speedup`` and
    ``efficiency`` against this run's single-device rows
    (``add_speedup_efficiency``), to ``parallel_results.csv``.

    A file that fails or exceeds ``timeout_s`` (see ``_time_limit``)
    produces a FAILED row and the sweep continues.

    ``seq_csv_name``: filename for the single-device rows, so a twin
    sweep does not overwrite the file sweep's CSV.

    ``twin``: corpora are made on the device instead of read from disk
    (family and size parsed from the filename; see ``_twin_for_file``).
    Rows carry ``input_mode=twin_device`` and the backend label gains
    ``_twin``; files whose names do not parse fall back to file mode for
    that row.

    Between rows the previous row's tensors are dropped and the CUDA
    caching allocator is emptied, outside any timed region, so a large
    row after a small one starts from a clean pool.
    """
    dev = resolve_device(device)
    # ``cuda`` or ``cpu``, recorded so rows from the two can never be
    # taken for each other.
    platform = dev.type
    results_dir = pathlib.Path(results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for ms in mesh_sizes:
        rows += _sweep(files, dev, platform, ms, verbose, timeout_s, twin)
    seq = [r for r in rows if "_sharded_" not in r["backend"]]
    par = [r for r in rows if "_sharded_" in r["backend"]]
    if seq:
        _write_rows(results_dir / seq_csv_name, seq)
    if par:
        _write_rows(results_dir / "parallel_results.csv",
                    add_speedup_efficiency(par, seq))
    return rows


def _sweep(files, dev, platform: str, ms, verbose: bool, timeout_s,
           twin: bool) -> list[dict]:
    """The rows of one backend: one device (``ms`` None) or ``ms``
    shards."""
    mesh = None
    backend = implementation_name(dev)
    processes = 1
    if ms is not None:
        from hpc_suffix_array_tpu_torch.parallel import make_mesh

        mesh = make_mesh(ms, device=dev)
        backend = f"{platform}_sharded_{ms}"
        processes = ms
    rows = []
    for path in files:
        text = text_dev = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        input_mode = "file"
        if twin:
            pair = _twin_for_file(path, dev)
            if pair is not None:
                text, text_dev = pair
                input_mode = "twin_device"
        if input_mode == "file":
            try:
                text = read_file(str(path))
            except OSError as e:
                if verbose:
                    print(f"[{backend}] {path} ... FAILED (read: {e})")
                rows.append(_failed_row(path, 0, backend, processes,
                                        f"read error: {e}", platform))
                continue
        # Twin rows get their own backend label so chart and report
        # groupings never mix device-born and file-staged timings.
        bk = backend + "_twin" if input_mode == "twin_device" else backend
        if verbose:
            print(f"[{bk}] {path} ({len(text) / MB:.1f} MB, "
                  f"{input_mode}) ... ", end="", flush=True)
        t0 = time.perf_counter()
        try:
            with _time_limit(timeout_s):
                r = run_benchmark(text, bk, input_mode, device=dev,
                                  text_dev=text_dev, mesh=mesh)
        except _PhaseTimeout as e:
            if verbose:
                print("TIMEOUT")
            rows.append(_failed_row(path, len(text), backend, processes,
                                    str(e), platform))
            continue
        except Exception as e:
            # Boundary of the sweep: one corpus's failure is recorded
            # and the other corpora still run.
            if verbose:
                print(f"FAILED ({type(e).__name__})")
            rows.append(_failed_row(path, len(text), backend, processes,
                                    f"{type(e).__name__}: {e}", platform))
            continue
        if verbose:
            print(f"OK ({time.perf_counter() - t0:.2f}s) "
                  f"LRS={r.lrs_length}")
        row = _row_for_file(path, r, bk, processes, platform)
        row["input_mode"] = input_mode
        rows.append(row)
    return rows


def add_speedup_efficiency(par: list[dict], seq: list[dict]) -> list[dict]:
    """speedup = seq sa_time / parallel sa_time; efficiency = speedup / P.
    Returns copies of the ``par`` rows with the derived columns.

    Each parallel row keeps its own ``builder`` and gains the baseline's
    ``baseline_builder``; when they differ, ``builder_mismatch`` is True
    and the pair measures the routing, not scaling (a single-device
    doubling baseline against a sharded MSD build). Charts exclude
    flagged pairs (viz/charts.py)."""
    seq = seq or []
    seq_times = {r["file"]: r["sa_time"] for r in seq}
    seq_builders = {r["file"]: r["builder"] for r in seq if "builder" in r}

    def unset(b) -> bool:
        return b is None or b == "" or b != b or str(b) == "nan"

    out = []
    for row in par:
        r = dict(row)
        r["speedup"] = (seq_times.get(r["file"], 0) / r["sa_time"]
                        if r["sa_time"] > 0 else 0)
        r["efficiency"] = (r["speedup"] / r["processes"]
                           if r["processes"] > 0 else 0)
        r["baseline_builder"] = seq_builders.get(r["file"], "")
        b, sb = r.get("builder", ""), r["baseline_builder"]
        # A sharded build paired with the same-algorithm single-device
        # baseline is the honest comparison; sharded_msd against
        # doubling is not.
        r["builder_mismatch"] = (
            not unset(b) and not unset(sb)
            and str(b).replace("sharded_", "")
            != str(sb).replace("sharded_", ""))
        out.append(r)
    return out
