"""The Makefile's port targets: a ``-torch`` sibling for each JAX
target, on the port only, and the JAX targets as they were."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Every rule of the Makefile before the port's targets: target ->
# (prerequisites, recipe lines). The JAX targets must keep them;
# ``clean`` and ``help`` serve both packages and may only gain lines.
SEED_RULES = {
    'test': ('', [
        '$(PY) -m pytest tests/ -q',
    ]),
    'test-correctness': ('', [
        '$(PY) -m hpc_suffix_array_tpu.cli banana | grep -q "\'ana\' (length: 3)"',
        '$(PY) -m hpc_suffix_array_tpu.cli mississippi | grep -q "\'issi\' (length: 4)"',
        '$(PY) -m hpc_suffix_array_tpu.cli abcabcabc | grep -q "\'abcabc\' (length: 6)"',
        '@echo "golden correctness: OK"',
    ]),
    'test-parallel': ('', [
        'JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\',
        '  $(PY) -m pytest tests/test_parallel.py -q',
    ]),
    'test-distributed': ('data', [
        '$(PY) -m hpc_suffix_array_tpu.cli test_data/banana.txt --spawn 2 \\',
        '  | grep -q "MPI_PROCESSES:2"',
        '@echo "distributed CLI: OK"',
    ]),
    'bench': ('', [
        '$(PY) bench.py',
    ]),
    'bench-all': ('', [
        '$(PY) -m hpc_suffix_array_tpu.bench.orchestrator --quick',
    ]),
    'data': ('', [
        '$(PY) -c "from hpc_suffix_array_tpu.datasets import *; \\',
        "  generate_test_fixtures('test_data'); \\",
        '  generate_standard_datasets(\'test_data\', random_mb=(1,), repetitive_mb=(1,), dna_mb=(10,))"',
    ]),
    'charts': ('', [
        '$(PY) -c "from hpc_suffix_array_tpu.viz import *; \\',
        '  generate_comparative_charts(); generate_multi_backend_report(); \\',
        '  generate_phase_breakdown_chart(\'results/benchmarks/sequential_results.csv\')"',
    ]),
    'clean': ('', [
        'rm -rf results __pycache__ **/__pycache__ .pytest_cache',
        'rm -f hpc_suffix_array_tpu/native/_native_*.so',
    ]),
    'help': ('', [
        '@echo "targets: test test-correctness test-parallel test-distributed bench bench-all data charts clean"',
    ]),
    'weak-scaling': ('', [
        'python -m hpc_suffix_array_tpu.bench.weak_scaling',
    ]),
    'bench-full': ('', [
        'python -m hpc_suffix_array_tpu.bench.orchestrator --random-mb 1 50 100 500',
    ]),
}
SHARED = ("clean", "help")
JAX_TARGETS = [t for t in SEED_RULES if t not in SHARED]


def rules(text: str) -> dict:
    """target -> (prerequisites, recipe lines) of a Makefile's text."""
    out, cur = {}, None
    for line in text.splitlines():
        if line.startswith("\t") and cur:
            out[cur][1].append(line[1:])
            continue
        m = re.match(r"^([A-Za-z0-9_-]+):(?!=)\s*(.*)$", line)
        cur = m.group(1) if m else None
        if m:
            out[cur] = (m.group(2).strip(), [])
    return out


@pytest.fixture(scope="module")
def makefile() -> dict:
    return rules((ROOT / "Makefile").read_text())


def _recipe(rules_: dict, target: str) -> str:
    """The target's recipe with its prerequisites' recipes."""
    deps, lines = rules_[target]
    return "\n".join([_recipe(rules_, d) for d in deps.split()] + lines)


def test_jax_targets_unchanged(makefile):
    for target in JAX_TARGETS:
        assert makefile[target] == SEED_RULES[target], target
    for target in SHARED:
        deps, lines = makefile[target]
        seed_deps, seed_lines = SEED_RULES[target]
        assert deps == seed_deps and lines[:len(seed_lines)] == seed_lines


@pytest.mark.parametrize("target", JAX_TARGETS)
def test_torch_sibling_runs_the_port(target, makefile):
    sibling = f"{target}-torch"
    assert sibling in makefile
    recipe = _recipe(makefile, sibling)
    assert re.search(r"hpc_suffix_array_tpu_torch|bench_cuda\.py|"
                     r"tests/test_torch_", recipe), recipe
    assert not re.search(r"hpc_suffix_array_tpu\.|(^|\s)bench\.py", recipe)
    out = subprocess.run(["make", "-n", sibling], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    phony = re.findall(r"^\.PHONY:(.*)$", (ROOT / "Makefile").read_text(),
                       re.M)
    assert sibling in " ".join(phony).split()


def test_help_lists_the_siblings():
    out = subprocess.run(["make", "-s", "help"], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    for target in JAX_TARGETS:
        assert f"{target}-torch" in out.stdout.split()


def test_correctness_goldens_on_cpu():
    out = subprocess.run(
        ["make", "-s", "test-correctness-torch", "DEVICE=cpu",
         f"PY={sys.executable}"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "golden correctness (hpc_suffix_array_tpu_torch, cpu): OK" in (
        out.stdout)
