# Convenience driver — UX parity with the reference Makefile targets
# (reference Makefile:84-173: test / test-mpi / test-correctness /
# run-benchmark / generate-data / charts / clean / help), adapted to the
# TPU-native framework. All real logic lives in the Python package.

PY ?= python
# Device of the port's (-torch) targets: cuda (fails without a card) or cpu.
DEVICE ?= cuda

.PHONY: test test-correctness test-parallel test-distributed bench bench-all data charts clean help weak-scaling bench-full
.PHONY: test-torch test-correctness-torch test-parallel-torch test-distributed-torch bench-torch bench-all-torch data-torch charts-torch weak-scaling-torch bench-full-torch

test:
	$(PY) -m pytest tests/ -q

# Golden LRS answers (reference Makefile:131-138): banana->ana,
# mississippi->issi, abcabcabc->abcabc.
test-correctness:
	$(PY) -m hpc_suffix_array_tpu.cli banana | grep -q "'ana' (length: 3)"
	$(PY) -m hpc_suffix_array_tpu.cli mississippi | grep -q "'issi' (length: 4)"
	$(PY) -m hpc_suffix_array_tpu.cli abcabcabc | grep -q "'abcabc' (length: 6)"
	@echo "golden correctness: OK"

# Multi-device analog of `make test-mpi` (reference Makefile:126-128).
test-parallel:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
	  $(PY) -m pytest tests/test_parallel.py -q

# REAL multi-process run: 2 OS workers over jax.distributed on the
# banana fixture — the exact launch shape of the reference's
# `make test-mpi` (mpirun -np 4 ./bin/main_mpi test_data/banana.txt).
test-distributed: data
	$(PY) -m hpc_suffix_array_tpu.cli test_data/banana.txt --spawn 2 \
	  | grep -q "MPI_PROCESSES:2"
	@echo "distributed CLI: OK"

bench:
	$(PY) bench.py

bench-all:
	$(PY) -m hpc_suffix_array_tpu.bench.orchestrator --quick

data:
	$(PY) -c "from hpc_suffix_array_tpu.datasets import *; \
	  generate_test_fixtures('test_data'); \
	  generate_standard_datasets('test_data', random_mb=(1,), repetitive_mb=(1,), dna_mb=(10,))"

charts:
	$(PY) -c "from hpc_suffix_array_tpu.viz import *; \
	  generate_comparative_charts(); generate_multi_backend_report(); \
	  generate_phase_breakdown_chart('results/benchmarks/sequential_results.csv')"

clean:
	rm -rf results __pycache__ **/__pycache__ .pytest_cache
	rm -f hpc_suffix_array_tpu/native/_native_*.so
	rm -rf build/kernels build/native

help:
	@echo "targets: test test-correctness test-parallel test-distributed bench bench-all data charts clean"
	@echo "port (PyTorch/CUDA, DEVICE=$(DEVICE)): test-torch test-correctness-torch test-parallel-torch test-distributed-torch bench-torch bench-all-torch data-torch charts-torch weak-scaling-torch bench-full-torch"

# Weak-scaling proxy sweep on the virtual CPU mesh (commits evidence
# under results/weak_scaling/ — see BASELINE.md for the metric).
weak-scaling:
	python -m hpc_suffix_array_tpu.bench.weak_scaling

# Full pipeline at reference scale (datasets -> sweeps -> charts ->
# reports; reference run_all_benchmarks.py:46-88 + the 500 MB point).
bench-full:
	python -m hpc_suffix_array_tpu.bench.orchestrator --random-mb 1 50 100 500

# --- The PyTorch/CUDA port (hpc_suffix_array_tpu_torch), one sibling per
# target above. DEVICE=cpu runs them without a card.

test-torch:
	$(PY) -m pytest tests/test_torch_*.py -q

test-correctness-torch:
	$(PY) -m hpc_suffix_array_tpu_torch.cli banana --device $(DEVICE) | grep -q "'ana' (length: 3)"
	$(PY) -m hpc_suffix_array_tpu_torch.cli mississippi --device $(DEVICE) | grep -q "'issi' (length: 4)"
	$(PY) -m hpc_suffix_array_tpu_torch.cli abcabcabc --device $(DEVICE) | grep -q "'abcabc' (length: 6)"
	@echo "golden correctness (hpc_suffix_array_tpu_torch, $(DEVICE)): OK"

test-parallel-torch:
	$(PY) -m pytest tests/test_torch_parallel.py tests/test_torch_parallel_*.py -q

# Two OS workers over torch.distributed (gloo) on the banana fixture.
test-distributed-torch: data-torch
	$(PY) -m hpc_suffix_array_tpu_torch.cli test_data/banana.txt --spawn 2 --device cpu \
	  | grep -q "MPI_PROCESSES:2"
	@echo "distributed CLI (hpc_suffix_array_tpu_torch): OK"

bench-torch:
	$(PY) bench_cuda.py --device $(DEVICE)

bench-all-torch:
	$(PY) -m hpc_suffix_array_tpu_torch.bench.orchestrator --quick --device $(DEVICE)

data-torch:
	$(PY) -c "from hpc_suffix_array_tpu_torch.datasets import *; \
	  generate_test_fixtures('test_data'); \
	  generate_standard_datasets('test_data', random_mb=(1,), repetitive_mb=(1,), dna_mb=(10,))"

charts-torch:
	$(PY) -c "from hpc_suffix_array_tpu_torch.viz import *; \
	  generate_comparative_charts(); generate_multi_backend_report(); \
	  generate_phase_breakdown_chart('results/benchmarks/sequential_results.csv')"

weak-scaling-torch:
	$(PY) -m hpc_suffix_array_tpu_torch.bench.weak_scaling --device $(DEVICE)

bench-full-torch:
	$(PY) -m hpc_suffix_array_tpu_torch.bench.orchestrator --random-mb 1 50 100 500 --device $(DEVICE)
