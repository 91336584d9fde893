"""The port runs without JAX: it imports neither jax nor the JAX package
(nor ``bench.py``, the JAX package's headline), and its measurement path
(bench, ``bench_cuda.py``, utils, the text reports) runs without pandas
and matplotlib."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hpc_suffix_array_tpu_torch"

BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "hpc_suffix_array_tpu", "bench", "pandas",
             "matplotlib", "seaborn"):
    sys.modules[name] = None          # any import of these now fails
import hpc_suffix_array_tpu_torch as tsa
import hpc_suffix_array_tpu_torch.cli as cli
import hpc_suffix_array_tpu_torch.core.bigsort as bigsort
import hpc_suffix_array_tpu_torch.kernels.radix as radix
import hpc_suffix_array_tpu_torch.core.lcp_window as lcp_window
sa = tsa.build_suffix_array(b"banana", device="cpu")
for build in (lcp_window.build_lcp_array_window,
              lcp_window.build_lcp_array_sorted):
    assert build(b"banana", sa, device="cpu").tolist() == [0, 1, 3, 0, 0, 2]
import contextlib, io, runpy
argv, sys.argv = sys.argv, ["hpc_suffix_array_tpu_torch", "banana",
                            "--device", "cpu"]
buf = io.StringIO()
try:
    with contextlib.redirect_stdout(buf):
        runpy.run_module("hpc_suffix_array_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
else:
    raise AssertionError("__main__ did not exit")
sys.argv = argv
assert "'ana' (length: 3)" in buf.getvalue(), buf.getvalue()
assert sa.tolist() == [5, 3, 1, 0, 4, 2], sa
assert cli.main(["banana", "--device", "cpu", "--no-validate"]) == 0
sa, lcp = tsa.build_suffix_array_direct(b"mississippi", device="cpu",
                                        want_lcp=True)
assert sa.tolist() == [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2], sa
assert lcp.tolist() == [0, 1, 1, 4, 0, 0, 1, 0, 2, 1, 3], lcp
sa, lcp = tsa.build_suffix_array_big(b"mississippi", device="cpu",
                                     want_lcp=True, target_bucket=4,
                                     chunk_elems=4)
assert sa.tolist() == [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2], sa
assert lcp.tolist() == [0, 1, 1, 4, 0, 0, 1, 0, 2, 1, 3], lcp
sa, lcp = tsa.build_sa_lcp(b"banana", device="cpu")
assert sa.tolist() == [5, 3, 1, 0, 4, 2], sa
import hpc_suffix_array_tpu_torch.parallel as par
import hpc_suffix_array_tpu_torch.parallel.bigsort
import hpc_suffix_array_tpu_torch.parallel.bitonic
import hpc_suffix_array_tpu_torch.parallel.gather
import hpc_suffix_array_tpu_torch.parallel.rerank
import hpc_suffix_array_tpu_torch.parallel.shift
import hpc_suffix_array_tpu_torch.bench.mesh_sweep
mesh = par.make_mesh(4, devices=["cpu"])
sa, lcp = par.build_sa_lcp_sharded(b"mississippi", mesh)
assert sa.tolist() == [10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2], sa
assert lcp.tolist() == [0, 1, 1, 4, 0, 0, 1, 0, 2, 1, 3], lcp
assert par.is_valid_suffix_array_sharded(b"mississippi", sa, mesh)
sa, lcp = par.build_suffix_array_sharded_big(b"mississippi" * 20, mesh,
                                             want_lcp=True)
assert sa[:4].tolist() == [219, 208, 197, 186], sa
assert cli.main(["banana", "--device", "cpu", "--backend", "sharded",
                 "--devices", "2"]) == 0
import hpc_suffix_array_tpu_torch.cli_distributed as cli_distributed
import hpc_suffix_array_tpu_torch.parallel.multihost as multihost
import hpc_suffix_array_tpu_torch.bench.weak_scaling as weak_scaling
import hpc_suffix_array_tpu_torch.bench.weak_scaling_worker
import numpy as np
text = np.frombuffer(b"mississippi" * 20, np.uint8)
n_pad, start, stop = par.mp_local_geometry(len(text), mesh)
block = np.zeros(stop - start, np.uint8)
block[:len(text)] = text
sa, lcp = par.build_suffix_array_sharded_big_mp(block, len(text), mesh,
                                                want_lcp=True)
assert sa[0][:4].tolist() == [219, 208, 197, 186], sa
assert cli.main(["banana", "--distributed", "--device", "cpu"]) == 2
import tempfile
import hpc_suffix_array_tpu_torch.bench as bench
import hpc_suffix_array_tpu_torch.bench.orchestrator as orchestrator
import hpc_suffix_array_tpu_torch.bench.parse as parse
import hpc_suffix_array_tpu_torch.utils as utils
import hpc_suffix_array_tpu_torch.utils.profiling as profiling
import hpc_suffix_array_tpu_torch.viz as viz
from hpc_suffix_array_tpu_torch.datasets import generate_test_fixtures
r = bench.run_benchmark(b"mississippi", device="cpu", validate=True)
assert (r.lrs_length, r.valid, r.builder) == (4, True, "doubling"), r
with tempfile.TemporaryDirectory() as d:
    files = generate_test_fixtures(d + "/data")[:2]
    rows = bench.benchmark_corpora(files, results_dir=d, device="cpu",
                                   verbose=False)
    assert [row["lrs_length"] for row in rows] == [3, 4], rows
    csv_path = d + "/sequential_results.csv"
    assert "runs:      2" in viz.generate_statistics_report(
        csv_path, d + "/stats.txt").read_text()
    assert "[torch_cpu]" in viz.generate_multi_backend_report(
        d, d + "/multi.txt").read_text()
    assert len(utils.read_file(str(files[0]))) == 6
    rows = bench.benchmark_corpora(files[:1], results_dir=d, device="cpu",
                                   verbose=False, mesh_sizes=(None, 2))
    assert [row["backend"] for row in rows] == ["torch_cpu",
                                                "cpu_sharded_2"], rows
    with profiling.device_trace(d + "/trace", "cpu"):
        tsa.build_suffix_array(b"banana", device="cpu")
    assert profiling.read_trace(d + "/trace")
    try:
        viz.generate_performance_charts(csv_path, d + "/charts")
    except ImportError:
        pass                          # matplotlib is blocked: the call fails
    else:
        raise AssertionError("charts drew without matplotlib")
    # A chart step that fails is reported and the run exits 1.
    assert orchestrator.main(["--quick", "--device", "cpu", "--data-dir",
                              d + "/data", "--results-dir", d + "/res",
                              "--charts-dir", d + "/charts"]) == 1
import json, os
import hpc_suffix_array_tpu_torch.bench.headline as headline
assert headline.bench_text(8).tobytes() == b"sw1TNJPV"
os.environ.update(SA_BENCH_BYTES="4096", SA_BENCH_REPS="1",
                  SA_BENCH_SECONDARY="0", SA_BENCH_BASELINE_BYTES="4096")
argv, sys.argv = sys.argv, ["bench_cuda.py", "--device", "cpu"]
buf = io.StringIO()
try:
    with contextlib.redirect_stdout(buf):
        runpy.run_path("bench_cuda.py", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
else:
    raise AssertionError("bench_cuda.py did not exit")
sys.argv = argv
line = json.loads(buf.getvalue())
assert (line["n"], line["baseline"]) == (4096, "host_sais"), line
bad = [m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "pandas", "matplotlib", "seaborn")
       and sys.modules[m] is not None]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_measurement_path_imports_no_pandas_or_matplotlib():
    """Only viz/charts.py may import matplotlib, and only inside its
    functions; nothing imports pandas or seaborn."""
    pattern = re.compile(
        r"^(\s*)(import|from)\s+(pandas|matplotlib|seaborn)(\.|\s|$)", re.M)
    offenders = []
    for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "bench_cuda.py"]:
        for m in pattern.finditer(p.read_text()):
            inside_charts = (p.name == "charts.py" and m.group(1)
                             and m.group(3) == "matplotlib")
            if not inside_charts:
                offenders.append(str(p.relative_to(ROOT)))
    assert offenders == []


def test_no_source_imports_jax():
    """Neither the package nor its root scripts import jax, the JAX
    package or ``bench.py``."""
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|hpc_suffix_array_tpu|bench)(\.|\s|$)",
        re.M)
    sources = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "bench_cuda.py"]
    assert PKG / "bench" / "headline.py" in sources
    offenders = [str(p.relative_to(ROOT)) for p in sources
                 if pattern.search(p.read_text())]
    assert offenders == []


def _imported_modules(path: pathlib.Path):
    """(module, names) of every import in ``path``, at any depth."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            names = [a.name for a in node.names]
            yield node.module, names
            for name in names:
                yield f"{node.module}.{name}", []
        elif isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, []


@pytest.mark.parametrize("module", ["refine", "residue"])
def test_tie_finish_modules_import_no_builder(module):
    """``core/refine.py`` and ``core/residue.py`` lie below the
    carried-keys builders: neither imports ``core.bigsort``."""
    path = PKG / "core" / f"{module}.py"
    got = [m for m, _ in _imported_modules(path)
           if m == "hpc_suffix_array_tpu_torch.core.bigsort"]
    assert got == []


def test_no_module_takes_a_residue_name_from_the_builder():
    """The residue's names are imported from ``core.residue`` only, and
    ``core/bigsort.py`` imports ``core.refine`` at module level."""
    residue = ast.parse((PKG / "core" / "residue.py").read_text())
    moved = {n.name for n in residue.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    moved |= {t.id for n in residue.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)}
    offenders = []
    for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for m, names in _imported_modules(p):
            if m == "hpc_suffix_array_tpu_torch.core.bigsort":
                offenders += [(p.name, x) for x in names if x in moved]
    assert offenders == []
    bigsort = ast.parse((PKG / "core" / "bigsort.py").read_text())
    nested = [n for f in ast.walk(bigsort)
              if isinstance(f, ast.FunctionDef) for n in ast.walk(f)
              if isinstance(n, ast.ImportFrom)
              and n.module == "hpc_suffix_array_tpu_torch.core.refine"]
    assert nested == []
