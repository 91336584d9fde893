from hpc_suffix_array_tpu_torch.bench.timing import (
    BenchmarkResult, run_benchmark)
from hpc_suffix_array_tpu_torch.bench.micro import run_micro_benchmark
from hpc_suffix_array_tpu_torch.bench.harness import (
    benchmark_corpora, add_speedup_efficiency)

__all__ = [
    "BenchmarkResult",
    "run_benchmark",
    "run_micro_benchmark",
    "benchmark_corpora",
    "add_speedup_efficiency",
]
