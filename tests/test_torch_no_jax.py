"""The port runs without JAX: it imports neither jax nor the JAX package,
and its measurement path (bench, utils, the text reports) runs without
pandas and matplotlib."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hpc_suffix_array_tpu_torch"

BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "hpc_suffix_array_tpu", "pandas",
             "matplotlib", "seaborn"):
    sys.modules[name] = None          # any import of these now fails
import hpc_suffix_array_tpu_torch as tsa
import hpc_suffix_array_tpu_torch.cli as cli
import hpc_suffix_array_tpu_torch.core.bigsort as bigsort
import hpc_suffix_array_tpu_torch.kernels.radix as radix
sa = tsa.build_suffix_array(b"banana", device="cpu")
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
    for p in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for m in pattern.finditer(p.read_text()):
            inside_charts = (p.name == "charts.py" and m.group(1)
                             and m.group(3) == "matplotlib")
            if not inside_charts:
                offenders.append(str(p.relative_to(ROOT)))
    assert offenders == []


def test_no_source_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|hpc_suffix_array_tpu)(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += ["chip_smoke.py"] if pattern.search(
        (ROOT / "chip_smoke.py").read_text()) else []
    assert offenders == []
