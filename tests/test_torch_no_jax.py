"""The port runs without JAX: it imports neither jax nor the JAX package."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hpc_suffix_array_tpu_torch"

BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "hpc_suffix_array_tpu"):
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
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
       and sys.modules[m] is not None]
assert not bad, bad
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_RUN], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


def test_no_source_imports_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|hpc_suffix_array_tpu)(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += ["chip_smoke.py"] if pattern.search(
        (ROOT / "chip_smoke.py").read_text()) else []
    assert offenders == []
