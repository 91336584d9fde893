"""The port's multi-process CLI: the ``--spawn`` launcher and its workers.

Real processes on the CPU: ``--spawn 2 --device cpu`` starts two
``--distributed`` workers joined by gloo through a FileStore in
``tmp_path``. Process 0's MPI-dialect STRUCTURED_RESULTS must carry the
JAX package's fields (its ``results`` dict, read from
``hpc_suffix_array_tpu/cli_distributed.py``, printed by its own
``_print_structured``) plus PATH; the SA must validate and the LRS equal
the single-device port's. A worker that dies fails the launch, and the
launcher stops the others. Every launch runs under a timeout, in its own
session, so a hang fails the test instead of blocking the suite.
"""

import ast
import io
import json
import os
import pathlib
import re
import signal
import subprocess
import sys

import numpy as np
import pytest

from hpc_suffix_array_tpu import cli as jax_cli
from hpc_suffix_array_tpu_torch import cli
from hpc_suffix_array_tpu_torch.core.lrs import (
    find_longest_repeated_substring)
from hpc_suffix_array_tpu_torch.core.suffix_array import build_suffix_array
from hpc_suffix_array_tpu_torch.core.lcp import build_lcp_array

ROOT = pathlib.Path(__file__).resolve().parents[1]
MPI_BLOCK = re.compile(
    r"--- STRUCTURED_RESULTS ---\n(.*?)--- END_STRUCTURED_RESULTS ---", re.S)
SEQ_BLOCK = re.compile(r"===STRUCTURED_RESULTS===\n(.*?)===END_RESULTS===",
                       re.S)


def _env() -> dict:
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": str(ROOT) + (
        os.pathsep + path if path else "")}


def _run(cmd, timeout=120, env=None):
    """(rc, stdout, stderr) of ``cmd`` in its own session; on timeout the
    whole session is killed and the test fails."""
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT,
                            env=_env() if env is None else env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"{cmd} did not finish within {timeout} s")
    return proc.returncode, out, err


def _fields(block: str) -> dict:
    return dict(ln.split(":", 1) for ln in block.strip().splitlines())


def _jax_results_keys() -> list[str]:
    """The keys of the ``results`` dict of JAX ``run_distributed``."""
    tree = ast.parse((ROOT / "hpc_suffix_array_tpu" /
                      "cli_distributed.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "results"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no results dict in the JAX cli_distributed.py")


def _single_device_lrs(text: np.ndarray) -> bytes:
    sa = build_suffix_array(text, device="cpu")
    lcp = build_lcp_array(text, sa, device="cpu")
    return find_longest_repeated_substring(text, sa, lcp, device="cpu")


def _corpus(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "mixed":        # random text and a periodic tail
        return np.concatenate([
            np.frombuffer(b"abcdef", np.uint8)[rng.integers(0, 6, 30_000)],
            np.tile(np.frombuffer(b"xy", np.uint8), 1_000)])
    alnum = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
    # Two periodic halves: the carried keys refuse it, doubling builds it.
    return np.concatenate([np.tile(alnum[rng.integers(0, 36, 7)], 600),
                           np.tile(alnum[rng.integers(0, 36, 11)], 400)])


@pytest.mark.parametrize("kind,path,dialect", [
    ("mixed", "sharded_msd_mp", "mpi"),
    ("two_periods", "sharded_doubling", "both")])
def test_spawn_two_processes_on_a_file(tmp_path, kind, path, dialect):
    text = _corpus(kind)
    f = tmp_path / "corpus.txt"
    f.write_bytes(text.tobytes())
    args = [sys.executable, "-m", "hpc_suffix_array_tpu_torch.cli", str(f),
            "--spawn", "2", "--device", "cpu", "--coordinator",
            f"file://{tmp_path}/store"]
    if dialect != "mpi":
        args += ["--dialect", dialect]
    rc, out, err = _run(args)
    assert rc == 0, out + err
    assert "Valid suffix array: YES" in out
    kv = _fields(MPI_BLOCK.search(out).group(1))
    assert int(kv.pop("ACTUAL_STRING_LENGTH")) == len(text)
    assert int(kv.pop("MPI_PROCESSES")) == 2
    assert kv.pop("PATH") == path
    sa_t, lcp_t, total = (float(kv.pop(k)) for k in
                          ("SA_TIME", "LCP_TIME", "TOTAL_TIME"))
    assert sa_t > 0 and total >= sa_t and lcp_t >= 0 and not kv
    lrs = _single_device_lrs(text)
    assert (f"Longest repeated substring: '{lrs.decode()}' (length: "
            f"{len(lrs)})") in out
    assert out.count("--- STRUCTURED_RESULTS ---") == 1  # process 0 only
    if dialect == "both":
        seq = _fields(SEQ_BLOCK.search(out).group(1))
        assert seq["IMPLEMENTATION"] == "torch_cpu_sharded_mp"
        assert (seq["FILE_SIZE"], seq["PROCESSES"], seq["PATH"]) == (
            str(len(text)), "2", path)


WRAPPED_WORKER = r"""
import json, sys
from hpc_suffix_array_tpu_torch import cli, cli_distributed
out, argv = sys.argv[1], sys.argv[2:]
arrays = {}
rc = cli_distributed.run_distributed(cli.parse_args(argv),
                                     arrays)
if "--process-id" in argv and argv[argv.index("--process-id") + 1] == "0":
    with open(out, "w") as f:
        json.dump(arrays["results"], f)
sys.exit(rc)
"""

LAUNCH = r"""
import sys
from hpc_suffix_array_tpu_torch import cli, cli_distributed
worker = [sys.executable, "-c", sys.argv[1]] + sys.argv[2:3]
args = cli.parse_args(sys.argv[3:])
sys.exit(cli_distributed.spawn(args, worker=worker))
"""


def test_spawn_literal_results_match_the_jax_fields(tmp_path):
    """On a literal: process 0's results dict has the JAX dict's keys,
    and its MPI block is the JAX printer's for that dict plus PATH."""
    res_path = tmp_path / "results.json"
    rc, out, err = _run([
        sys.executable, "-c", LAUNCH, WRAPPED_WORKER, str(res_path),
        "mississippi", "--spawn", "2", "--device", "cpu", "--coordinator",
        f"file://{tmp_path}/store"])
    assert rc == 0, out + err
    results = json.loads(res_path.read_text())
    assert list(results) == _jax_results_keys()
    assert results["implementation"] == "torch_cpu_sharded_mp"
    assert (results["filename"], results["file_size"], results["processes"],
            results["valid"], results["lrs_length"], results["path"]) == (
        "direct_string", 11, 2, True, 4, "sharded_msd_mp")
    want = io.StringIO()
    jax_cli._print_structured(results, "mpi", want)
    got = MPI_BLOCK.search(out).group(0).splitlines()
    assert got == [ln for ln in want.getvalue().splitlines() if ln][:-1] + [
        "PATH:sharded_msd_mp", "--- END_STRUCTURED_RESULTS ---"]
    assert "Longest repeated substring: 'issi' (length: 4)" in out
    assert "Input string: mississippi" in out


def test_distributed_without_processes_exits_2(monkeypatch, capsys):
    for name in ("SA_NUM_PROCESSES", "SA_PROCESS_ID", "SA_COORDINATOR"):
        monkeypatch.delenv(name, raising=False)
    assert cli.main(["banana", "--distributed", "--device", "cpu"]) == 2
    assert "SA_NUM_PROCESSES" in capsys.readouterr().err
    assert cli.main(["banana", "--distributed", "--device", "cpu",
                     "--processes", "2"]) == 2


KILLED_WORKER = r"""
import os, signal, sys
from hpc_suffix_array_tpu_torch import cli
argv = sys.argv[1:]
if argv[argv.index("--process-id") + 1] == "1":
    os.kill(os.getpid(), signal.SIGKILL)
sys.exit(cli.main(argv))
"""

LAUNCH_KILLED = r"""
import sys
from hpc_suffix_array_tpu_torch import cli, cli_distributed
args = cli.parse_args(sys.argv[2:])
sys.exit(cli_distributed.spawn(args, worker=[sys.executable, "-c",
                                             sys.argv[1]]))
"""


def test_a_killed_worker_fails_the_launch(tmp_path):
    """Worker 1 dies by SIGKILL before it joins the group; worker 0 then
    waits for it, and the launcher stops it and exits nonzero."""
    rc, out, err = _run([
        sys.executable, "-c", LAUNCH_KILLED, KILLED_WORKER, "banana",
        "--spawn", "2", "--device", "cpu", "--coordinator",
        f"file://{tmp_path}/store"], timeout=90)
    assert rc == signal.SIGKILL, out + err
    assert "STRUCTURED_RESULTS" not in out
