"""In-framework micro-benchmark sweep.

Counterpart of ``hpc_suffix_array_tpu/bench/micro.py``: the size sweep
{1e3, 5e3, 1e4, 5e4, 1e5, 5e5, 1e6} x 3 repetitions on random text, plus
the repetitive family, written to a CSV with the same header.
"""

from __future__ import annotations

import csv
import pathlib

from hpc_suffix_array_tpu_torch.bench.timing import (
    BenchmarkResult, run_benchmark)
from hpc_suffix_array_tpu_torch.cli import implementation_name
from hpc_suffix_array_tpu_torch.datasets.generate import (
    generate_random_text, generate_repetitive_text)

SIZES = (1_000, 5_000, 10_000, 50_000, 100_000, 500_000, 1_000_000)
REPS = 3

# ``compile_time`` is the warm-up run minus the timed run (see
# bench/timing.py); keeping it out of the run times keeps the small-n
# rows meaningful.
CSV_HEADER = ["implementation", "input_type", "string_length", "total_time",
              "sa_time", "lcp_time", "lrs_time", "memory_used",
              "compile_time"]


def run_micro_benchmark(out_csv="results/csv/benchmark_results_torch.csv",
                        sizes=SIZES, reps: int = REPS, device="cuda",
                        input_types=("random", "repetitive"),
                        verbose: bool = True) -> list[BenchmarkResult]:
    """Run the sweep on ``device``; returns the results and writes the
    CSV. ``implementation`` is the CLI's name for the device."""
    impl = implementation_name(device)
    gens = {"random": generate_random_text,
            "repetitive": generate_repetitive_text}
    results = []
    for input_type in input_types:
        for size in sizes:
            for rep in range(reps):
                text = gens[input_type](size, seed=rep)
                r = run_benchmark(text, impl, input_type, device=device)
                results.append(r)
                if verbose:
                    print(f"{impl} {input_type} n={size} rep={rep}: "
                          f"total={r.total_time:.4f}s sa={r.sa_time:.4f}s")

    path = pathlib.Path(out_csv)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for r in results:
            w.writerow([r.implementation, r.input_type, r.string_length,
                        f"{r.total_time:.6f}", f"{r.sa_time:.6f}",
                        f"{r.lcp_time:.6f}", f"{r.lrs_time:.6f}",
                        r.memory_used, f"{r.compile_time:.6f}"])
    if verbose:
        print(f"Results saved to {path}")
    return results
