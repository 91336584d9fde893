"""Benchmark charting: performance and comparative analysis figures.

Counterpart of ``hpc_suffix_array_tpu/viz/charts.py``: the 4-quadrant
analysis (log-log time against size, throughput, an O(n log n) overlay,
growth-factor bars), the phase-breakdown figure, and the multi-backend
time / throughput / speedup / efficiency quadrants, from the CSVs the
harness writes.

matplotlib is imported inside the functions: importing this module needs
only numpy, and a machine without matplotlib fails at the call, where
the orchestrator reports the step as failed.
"""

from __future__ import annotations

import pathlib

import numpy as np

from hpc_suffix_array_tpu_torch.viz.report import (
    RESULT_CSVS, column, read_rows, sorted_by_size, succeeded)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ensure(path) -> pathlib.Path:
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def generate_performance_charts(results_csv, out_dir="results/charts"):
    """Single-backend 4-quadrant analysis. FAILED rows are left out."""
    plt = _pyplot()
    out = _ensure(out_dir)
    rows = succeeded(sorted_by_size(read_rows(results_csv)))
    if not rows:
        return []
    n = column(rows, "size_bytes")
    sa_time = column(rows, "sa_time")

    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    fig.suptitle("Suffix Array Performance Analysis (PyTorch/CUDA port)")

    ax = axes[0, 0]
    ax.loglog(n, sa_time, "o-", label="measured SA build")
    # O(n log n) overlay anchored at the first point
    theory = n * np.log2(np.maximum(n, 2))
    theory = theory / theory[0] * max(float(sa_time[0]), 1e-9)
    ax.loglog(n, theory, "--", label="O(n log n) (scaled)")
    ax.set_xlabel("input size (bytes)")
    ax.set_ylabel("SA build time (s)")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)

    ax = axes[0, 1]
    ax.semilogx(n, column(rows, "throughput_mb_s"), "s-")
    ax.set_xlabel("input size (bytes)")
    ax.set_ylabel("throughput (MB/s)")
    ax.grid(True, alpha=0.3)

    ax = axes[1, 0]
    if len(rows) > 1:
        ratio_t = sa_time[1:] / sa_time[:-1]
        ratio_n = n[1:] / n[:-1]
        growth = ratio_t / ratio_n     # ~1 means linear scaling per size step
        labels = [f"{int(a)}→{int(b)}" for a, b in zip(n[:-1], n[1:])]
        ax.bar(range(len(growth)), growth)
        ax.set_xticks(range(len(growth)), labels, rotation=45, fontsize=7)
        ax.axhline(1.0, color="k", ls="--", alpha=0.5)
        ax.set_ylabel("growth factor (time ratio / size ratio)")
    ax.grid(True, alpha=0.3)

    ax = axes[1, 1]
    bottom = np.zeros(len(rows))
    for phase in ("sa_time", "lcp_time"):
        if phase in rows[0]:
            vals = column(rows, phase)
            ax.bar([str(int(x)) for x in n], vals, bottom=bottom,
                   label=phase)
            bottom = bottom + vals
    ax.set_ylabel("time (s)")
    ax.set_xlabel("input size (bytes)")
    ax.tick_params(axis="x", rotation=45, labelsize=7)
    ax.legend()

    fig.tight_layout()
    path = out / "performance_analysis.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return [path]


def generate_phase_breakdown_chart(results_csv, out_dir="results/charts"):
    """Per-phase breakdown figure: the left panel stacks absolute SA /
    LCP / LRS seconds per corpus size; the right panel normalizes to
    100%, so which phase dominates where is readable across orders of
    magnitude of input size. FAILED rows are left out."""
    plt = _pyplot()
    out = _ensure(out_dir)
    rows = succeeded(sorted_by_size(read_rows(results_csv)))
    phases = [p for p in ("sa_time", "lcp_time", "lrs_time")
              if rows and p in rows[0]]
    if not rows or not phases:
        return []

    fig, (ax_abs, ax_rel) = plt.subplots(1, 2, figsize=(14, 5.5))
    fig.suptitle("Phase Breakdown: SA build / LCP build / LRS search")

    labels = [f"{b / (1 << 20):.2g}MB" if b >= 1 << 20 else str(int(b))
              for b in column(rows, "size_bytes")]
    totals = np.maximum(sum(column(rows, p) for p in phases), 1e-12)

    for ax, norm in ((ax_abs, None), (ax_rel, totals)):
        bottom = np.zeros(len(rows))
        for phase in phases:
            vals = column(rows, phase)
            if norm is not None:
                vals = 100.0 * vals / norm
            ax.bar(labels, vals, bottom=bottom,
                   label=phase.replace("_time", ""))
            bottom += vals
        ax.tick_params(axis="x", rotation=45, labelsize=7)
        ax.legend()
        ax.grid(True, axis="y", alpha=0.3)
    ax_abs.set_ylabel("time (s)")
    ax_rel.set_ylabel("share of total (%)")
    ax_rel.set_ylim(0, 100)

    fig.tight_layout()
    path = out / "phase_breakdown.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return [path]


def generate_comparative_charts(results_dir="results/benchmarks",
                                out_dir="results/charts"):
    """Multi-backend comparison: time, throughput, speedup, efficiency.
    The twin sweep (backend label ``*_twin``) is its own line beside the
    file rows, which include reading and staging."""
    plt = _pyplot()
    out = _ensure(out_dir)
    rd = pathlib.Path(results_dir)
    rows = [r for name in RESULT_CSVS if (rd / name).exists()
            for r in read_rows(rd / name)]
    if not rows:
        return []
    rows = sorted_by_size(rows)

    def by_backend(group):
        for backend in sorted({r["backend"] for r in group}):
            yield backend, [r for r in group if r["backend"] == backend]

    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    fig.suptitle("Backend Comparison (PyTorch/CUDA port)")

    for backend, g in by_backend(rows):
        axes[0, 0].loglog(column(g, "size_bytes"), column(g, "sa_time"),
                          "o-", label=backend)
        axes[0, 1].semilogx(column(g, "size_bytes"),
                            column(g, "throughput_mb_s"), "s-",
                            label=backend)
    axes[0, 0].set_xlabel("bytes")
    axes[0, 0].set_ylabel("SA time (s)")
    axes[0, 0].legend()
    axes[0, 1].set_xlabel("bytes")
    axes[0, 1].set_ylabel("MB/s")
    axes[0, 1].legend()

    # Pairs whose baseline ran a different builder measure the routing,
    # not scaling (bench/harness.add_speedup_efficiency): they stay in
    # the CSV, labeled, but never plot as efficiency.
    par = [r for r in rows if "_sharded_" in str(r["backend"])
           and not r.get("builder_mismatch", False) and "speedup" in r]
    if par:
        for backend, g in by_backend(par):
            axes[1, 0].semilogx(column(g, "size_bytes"),
                                column(g, "speedup"), "o-", label=backend)
            axes[1, 1].semilogx(column(g, "size_bytes"),
                                column(g, "efficiency"), "o-",
                                label=backend)
        axes[1, 0].axhline(1.0, color="k", ls="--", alpha=0.5)
        axes[1, 0].set_ylabel("speedup vs single device")
        axes[1, 1].set_ylabel("parallel efficiency")
        axes[1, 1].set_ylim(0, 1.2)
        for ax in (axes[1, 0], axes[1, 1]):
            ax.set_xlabel("bytes")
            ax.legend()
            ax.grid(True, alpha=0.3)

    fig.tight_layout()
    path = out / "backend_comparison.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return [path]
