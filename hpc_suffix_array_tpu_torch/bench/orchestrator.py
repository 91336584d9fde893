"""Benchmark orchestrator: datasets -> sweeps -> CSVs -> charts -> reports.

Counterpart of ``hpc_suffix_array_tpu/bench/orchestrator.py`` for one
device. ``--device`` (default ``cuda``) is resolved before any step: a
card that is not there is a usage error and never turns into a CPU run.
In-process calls replace a per-script subprocess boundary, so one Python
failure cannot silently zero a whole sweep; a step that raises is
reported as FAIL and the run exits 1. The chart steps need matplotlib
and fail in that way on a machine without it.

Run: ``python -m hpc_suffix_array_tpu_torch.bench.orchestrator [--quick]
[--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import sys
import traceback

from hpc_suffix_array_tpu_torch.device import resolve_device


def detect_environment() -> dict:
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "devices": cards,
        "platforms": ["cpu"] + (["cuda"] if cards else []),
        "accelerator": cards > 0,
        "kinds": [torch.cuda.get_device_name(i) for i in range(cards)],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sa-bench-all-torch")
    p.add_argument("--quick", action="store_true",
                   help="small fixtures only (CI-sized run)")
    p.add_argument("--device", default="cuda",
                   help="torch device to build on (default: cuda; raises "
                        "when CUDA is unavailable)")
    p.add_argument("--data-dir", default="test_data")
    p.add_argument("--results-dir", default="results/benchmarks")
    p.add_argument("--charts-dir", default="results/charts")
    p.add_argument("--random-mb", type=int, nargs="*", default=[1, 50, 100])
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    from hpc_suffix_array_tpu_torch.bench.harness import (
        TWIN_NAME, benchmark_corpora)
    from hpc_suffix_array_tpu_torch.bench.micro import (
        SIZES, run_micro_benchmark)
    from hpc_suffix_array_tpu_torch.datasets.generate import (
        generate_standard_datasets, generate_test_fixtures)
    from hpc_suffix_array_tpu_torch.viz import (
        generate_comparative_charts, generate_multi_backend_report,
        generate_performance_charts, generate_phase_breakdown_chart,
        generate_statistics_report)

    print(f"environment: {detect_environment()}; device: {device}")
    steps, failures = [], []

    def step(name, fn):
        print(f"\n=== {name} ===")
        try:
            out = fn()
            steps.append((name, True))
            return out
        except Exception:
            # Boundary of the run: the step is reported as failed and
            # the later steps still run.
            traceback.print_exc()
            steps.append((name, False))
            failures.append(name)
            return None

    fixtures = step("generate fixtures",
                    lambda: generate_test_fixtures(args.data_dir)) or []
    if not args.quick:
        corpora = step(
            "generate corpora",
            lambda: generate_standard_datasets(
                args.data_dir, random_mb=tuple(args.random_mb),
                repetitive_mb=(1,), dna_mb=(10,))) or []
    else:
        corpora = []

    step("micro benchmark",
         lambda: run_micro_benchmark(
             out_csv=f"{args.results_dir}/micro_results.csv",
             sizes=(1_000, 10_000, 100_000) if args.quick else SIZES,
             reps=1 if args.quick else 3, device=device))

    files = fixtures if args.quick else list(corpora)
    step("corpus sweep",
         lambda: benchmark_corpora(files, results_dir=args.results_dir,
                                   device=device))
    if not args.quick:
        # The same sweep with corpora made on the device: the file sweep
        # above proves the I/O contract; this one times the build alone.
        step("twin corpus sweep",
             lambda: benchmark_corpora(
                 [f for f in files if TWIN_NAME.match(f.name)],
                 results_dir=args.results_dir, device=device,
                 seq_csv_name="sequential_results_twin.csv", twin=True))

    seq_csv = f"{args.results_dir}/sequential_results.csv"
    step("performance charts",
         lambda: generate_performance_charts(seq_csv, args.charts_dir))
    step("phase breakdown chart",
         lambda: generate_phase_breakdown_chart(seq_csv, args.charts_dir))
    step("comparative charts",
         lambda: generate_comparative_charts(args.results_dir,
                                             args.charts_dir))
    step("statistics report",
         lambda: generate_statistics_report(
             seq_csv, f"{args.charts_dir}/performance_statistics.txt"))
    step("multi-backend report",
         lambda: generate_multi_backend_report(
             args.results_dir, f"{args.charts_dir}/multi_backend_report.txt"))

    print("\n=== SUMMARY ===")
    for name, ok in steps:
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
