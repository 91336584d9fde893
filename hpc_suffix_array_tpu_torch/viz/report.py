"""Text statistics reports for benchmark runs.

Counterpart of ``hpc_suffix_array_tpu/viz/report.py``: the complexity
classification and the multi-backend summary, with the same lines for
the same CSV. The CSVs are read with the ``csv`` module and the fits use
numpy, so a report needs no pandas.
"""

from __future__ import annotations

import csv
import math
import pathlib
import platform
from datetime import datetime

import numpy as np

RESULT_CSVS = ("sequential_results.csv", "sequential_results_twin.csv",
               "sequential_results_cpu.csv", "parallel_results.csv")
_TEXT_COLUMNS = ("file", "backend", "platform", "builder", "error",
                 "timestamp", "input_mode", "baseline_builder",
                 "scaling_mode")
_BOOL_COLUMNS = ("success", "builder_mismatch")


def read_rows(path) -> list[dict]:
    """A results CSV as row dicts: text columns as strings, ``success``
    and ``builder_mismatch`` as bools, every other column as a float
    (an empty cell is NaN)."""
    with open(path, newline="") as f:
        raw = list(csv.DictReader(f))
    rows = []
    for r in raw:
        row = {}
        for k, v in r.items():
            if k in _TEXT_COLUMNS:
                row[k] = v
            elif k in _BOOL_COLUMNS:
                row[k] = v.strip().lower() in ("true", "1", "1.0")
            elif v == "":
                row[k] = math.nan
            else:
                try:
                    row[k] = float(v)
                except ValueError:
                    row[k] = v              # a text column not listed above
        rows.append(row)
    return rows


def sorted_by_size(rows: list[dict]) -> list[dict]:
    return sorted(rows, key=lambda r: r["size_bytes"])


def succeeded(rows: list[dict]) -> list[dict]:
    """The rows that ran: FAILED rows (size 0 for an unreadable file, all
    times 0) have no place in a fit, a ratio or a stacked bar."""
    return [r for r in rows if r.get("success", True)]


def column(rows: list[dict], name: str) -> np.ndarray:
    return np.array([r.get(name, math.nan) for r in rows], float)


def _classify_complexity(sizes: np.ndarray, times: np.ndarray) -> str:
    """Fit time ~ n^alpha and name the class of alpha."""
    if len(sizes) < 2:
        return "insufficient data"
    alpha = np.polyfit(np.log(sizes), np.log(np.maximum(times, 1e-12)), 1)[0]
    if alpha < 1.15:
        cls = "~linear O(n)"
    elif alpha < 1.35:
        cls = "~linearithmic O(n log n)"
    elif alpha < 2.2:
        cls = "~quadratic O(n^2)"
    else:
        cls = "super-quadratic"
    return f"{cls} (fitted exponent {alpha:.2f})"


def generate_statistics_report(results_csv, out_path="results/charts/"
                               "performance_statistics.txt") -> pathlib.Path:
    rows = sorted_by_size(read_rows(results_csv))
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        "SUFFIX ARRAY PERFORMANCE STATISTICS (PyTorch/CUDA port)",
        "=" * 60,
        f"generated: {datetime.now():%Y-%m-%d %H:%M:%S}",
        f"platform:  {platform.platform()}",
        f"runs:      {len(rows)}",
        "",
    ]
    if rows:
        sizes = column(rows, "size_bytes")
        thr = column(rows, "throughput_mb_s")
        ok = succeeded(rows)        # FAILED rows stay in the detail lines
        lines += [
            f"input sizes: {int(sizes.min())} .. {int(sizes.max())} bytes",
            f"best throughput: {np.nanmax(thr):.2f} MB/s",
            f"mean throughput: {np.nanmean(thr):.2f} MB/s",
            "complexity fit (SA build): " + _classify_complexity(
                column(ok, "size_bytes"), column(ok, "sa_time")),
            "",
            "per-run detail:",
        ]
        for r in rows:
            lines.append(
                f"  {r['file'] if 'file' in r else r.get('backend', '?'):30s}"
                f" {int(r['size_bytes']):>12d} B  sa={r['sa_time']:.4f}s"
                f"  lcp={r['lcp_time']:.4f}s  {r['throughput_mb_s']:8.2f} MB/s")
    out.write_text("\n".join(lines) + "\n")
    return out


def generate_multi_backend_report(results_dir="results/benchmarks",
                                  out_path="results/charts/"
                                  "multi_backend_report.txt") -> pathlib.Path:
    rd = pathlib.Path(results_dir)
    rows = [r for name in RESULT_CSVS if (rd / name).exists()
            for r in read_rows(rd / name)]
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        "MULTI-BACKEND COMPARISON REPORT (PyTorch/CUDA port)",
        "=" * 60,
        f"generated: {datetime.now():%Y-%m-%d %H:%M:%S}",
        "",
    ]
    if rows:
        for backend in sorted({r["backend"] for r in rows}):
            g = [r for r in rows if r["backend"] == backend]
            thr = column(g, "throughput_mb_s")
            lines += [
                f"[{backend}]",
                f"  runs: {len(g)}",
                f"  mean throughput: {np.nanmean(thr):.2f} MB/s",
                f"  best throughput: {np.nanmax(thr):.2f} MB/s",
            ]
            speedup = column(g, "speedup")
            if not np.isnan(speedup).all():
                lines += [
                    f"  mean speedup:    {np.nanmean(speedup):.2f}x",
                    f"  mean efficiency: "
                    f"{np.nanmean(column(g, 'efficiency')):.2%}",
                ]
            lines.append("")
    else:
        lines.append("no results found")
    out.write_text("\n".join(lines) + "\n")
    return out
