"""CLI of the port against the JAX package's CLI.

The structured fields and the human report must match line for line,
apart from IMPLEMENTATION and the times.
"""

import io
import re

import numpy as np
import pytest
import torch

from hpc_suffix_array_tpu import cli as jax_cli
from hpc_suffix_array_tpu_torch import cli

TIME_LINE = re.compile(r"(TIME:|time:|IMPLEMENTATION:)")


def _comparable(out: str) -> list[str]:
    """Report lines without times and the implementation name."""
    return [ln for ln in out.splitlines() if not TIME_LINE.search(ln)]


def _fields(out: str) -> dict:
    return dict(ln.split(":", 1) for ln in out.splitlines()
                if re.fullmatch(r"[A-Z_]+:.*", ln))


@pytest.mark.parametrize("dialect", ["sequential", "mpi", "both"])
def test_run_matches_jax_cli(dialect):
    text = np.frombuffer(b"banana", np.uint8)
    got, want = io.StringIO(), io.StringIO()
    res = cli.run(text, "direct_string", "cpu", validate=True,
                  dialect=dialect, out=got)
    jax_cli.run(text, "direct_string", "single", None, validate=True,
                dialect=dialect, out=want)
    assert _comparable(got.getvalue()) == _comparable(want.getvalue())
    if dialect != "mpi":
        assert "IMPLEMENTATION:torch_cpu" in got.getvalue()
    assert res["valid"] is True and res["lrs_length"] == 3
    assert res["rounds"] >= 1 and res["plcp_rounds"] >= 1


@pytest.mark.parametrize("dialect", ["sequential", "mpi"])
def test_main_on_file_matches_jax_cli(tmp_path, capsys, dialect):
    path = tmp_path / "corpus.txt"
    path.write_bytes(np.random.default_rng(4).choice(
        np.frombuffer(b"ACGT", np.uint8), 3000).tobytes())
    assert cli.main([str(path), "--device", "cpu", "--dialect",
                     dialect]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main([str(path), "--dialect", dialect]) == 0
    want = capsys.readouterr().out
    assert "Valid suffix array: YES" in got
    assert _comparable(got) == _comparable(want)
    g, w = _fields(got), _fields(want)
    for key in [k for k in w if "TIME" in k or k == "IMPLEMENTATION"]:
        g.pop(key, None)
        w.pop(key)
    assert g == w


@pytest.mark.parametrize("dialect", ["sequential", "mpi", "both"])
def test_rerun_matches_jax_cli(monkeypatch, dialect):
    """A chain-mode misprediction on the fused route: both CLIs report
    PATH:direct and RERUN:chain_to_ascending (RERUN in both dialects)."""
    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    monkeypatch.setenv("SA_CHAIN_EST_MIN", "100")
    alnum = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8)
    text = alnum[np.random.default_rng(9).integers(0, 36, 30_000)]
    text[15_000:15_300] = text[:300]     # one repeat, not a period
    got, want = io.StringIO(), io.StringIO()
    res = cli.run(text, "rerun.txt", "cpu", validate=True, dialect=dialect,
                  out=got)
    jax_cli.run(text, "rerun.txt", "single", None, validate=True,
                dialect=dialect, out=want)
    assert _comparable(got.getvalue()) == _comparable(want.getvalue())
    assert res["path"] == "direct" and res["rerun"] == "chain_to_ascending"
    assert got.getvalue().count("RERUN:chain_to_ascending") == (
        2 if dialect == "both" else 1)
    if dialect != "mpi":
        assert "PATH:direct" in got.getvalue()


def test_main_string_golden(capsys):
    assert cli.main(["mississippi", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Longest repeated substring: 'issi' (length: 4)" in out
    assert "IMPLEMENTATION:torch_cpu" in out
    assert re.search(r"SA_TIME:([0-9.]+)", out)


def test_no_validate(capsys):
    assert cli.main(["banana", "--device", "cpu", "--no-validate"]) == 0
    assert "Valid suffix array" not in capsys.readouterr().out


def test_failed_build_prints_failed_block(monkeypatch, capsys):
    from hpc_suffix_array_tpu_torch.core import suffix_array

    def boom(*args, **kwargs):
        raise MemoryError("simulated device OOM")

    monkeypatch.setattr(suffix_array, "build_suffix_array", boom)
    assert cli.main(["banana", "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert "STATUS:FAILED" in captured.out
    assert "ERROR:MemoryError" in captured.out
    assert "IMPLEMENTATION:torch_cpu" in captured.out
    assert "build failed" in captured.err


def test_missing_file_exits_nonzero(tmp_path, capsys):
    assert cli.main([str(tmp_path / "absent.txt"), "--device", "cpu"]) == 1
    assert "Failed to read input file" in capsys.readouterr().err


def test_cuda_default_raises_without_cuda(monkeypatch):
    """The default device is cuda; without CUDA the CLI raises and never
    runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["banana"])
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["banana", "--device", "cuda"])


# --- the sharded backend ----------------------------------------------------

MESH_LINE = re.compile(r"^mesh: \d+ shards on \d+ ")


def _sharded_comparable(out: str) -> list[str]:
    """``_comparable`` without the port's mesh line."""
    return [ln for ln in _comparable(out) if not MESH_LINE.match(ln)]


@pytest.mark.parametrize("dialect", ["sequential", "mpi", "both"])
def test_sharded_main_matches_jax_cli(capsys, dialect):
    args = ["abcabcabc", "--backend", "sharded", "--devices", "4",
            "--dialect", dialect]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert _sharded_comparable(got) == _sharded_comparable(want)
    g, w = _fields(got), _fields(want)
    for key in [k for k in w if "TIME" in k or k == "IMPLEMENTATION"]:
        g.pop(key, None)
        w.pop(key)
    assert g == w
    assert "mesh: 4 shards on 1 cpu device(s)" in got
    assert ("PROCESSES:4" in got) and ("MPI_PROCESSES:4" in got) == (
        dialect != "sequential")
    if dialect != "mpi":
        assert "IMPLEMENTATION:torch_cpu_sharded" in got
        assert "PATH:sharded_doubling" in got


@pytest.mark.parametrize("devices", ["2", "8"])
def test_sharded_main_on_file_matches_jax_cli(tmp_path, capsys, devices):
    path = tmp_path / "corpus.txt"
    path.write_bytes(np.random.default_rng(6).choice(
        np.frombuffer(b"ACGT", np.uint8), 3000).tobytes())
    args = [str(path), "--backend", "sharded", "--devices", devices]
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert "Valid suffix array: YES" in got
    assert _sharded_comparable(got) == _sharded_comparable(want)


def test_sharded_run_fused_route(monkeypatch):
    """Above SA_SHARDED_MSD_MIN the sharded SA phase builds SA and LCP
    together (build_sa_lcp_sharded: one carried-keys sort, the JAX
    package's path on the same text); the report matches the
    single-device backend's apart from times, path and processes."""
    from hpc_suffix_array_tpu import parallel as jpar

    monkeypatch.setenv("SA_SHARDED_MSD_MIN", "1000")
    text = np.random.default_rng(2).integers(97, 101, 5000).astype(np.uint8)
    got, single = io.StringIO(), io.StringIO()
    arrays: dict = {}
    res = cli.run(text, "fused.txt", "cpu", validate=True,
                  dialect="sequential", out=got, arrays=arrays,
                  backend="sharded", n_devices=2)
    ref: dict = {}
    cli.run(text, "fused.txt", "cpu", validate=True, dialect="sequential",
            out=single, arrays=ref)
    j_info: dict = {}
    jpar.build_sa_lcp_sharded(text, jpar.make_mesh(2), info=j_info)
    assert res["path"] == j_info["path"] == "sharded_msd"
    assert res["processes"] == 2
    assert res["valid"] is True and res["plcp_rounds"] == 0
    assert torch.equal(arrays["sa"], ref["sa"])
    assert torch.equal(arrays["lcp"], ref["lcp"])
    keep = [ln for ln in _sharded_comparable(got.getvalue())
            if not ln.startswith(("PATH:", "PROCESSES:"))]
    assert keep == [ln for ln in _comparable(single.getvalue())
                    if not ln.startswith(("PATH:", "PROCESSES:"))]


def test_sharded_run_with_a_mesh():
    from hpc_suffix_array_tpu_torch.parallel import make_mesh

    mesh = make_mesh(8, devices=["cpu"])
    text = np.frombuffer(b"mississippi", np.uint8)
    out = io.StringIO()
    res = cli.run(text, "direct_string", "cpu", validate=True,
                  dialect="sequential", out=out, backend="sharded",
                  mesh=mesh)
    assert res["processes"] == 8 and res["valid"] is True
    assert res["implementation"] == "torch_cpu_sharded"
    assert res["lrs_length"] == 4
    with pytest.raises(ValueError, match="sharded"):
        cli.run(text, "direct_string", "cpu", validate=True,
                dialect="sequential", out=out, mesh=mesh)


def test_sharded_devices_must_be_a_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        cli.main(["banana", "--backend", "sharded", "--devices", "3",
                  "--device", "cpu"])


def test_sharded_failed_build_names_the_backend(monkeypatch, capsys):
    import hpc_suffix_array_tpu_torch.parallel as tpar

    def boom(*args, **kwargs):
        raise MemoryError("simulated device OOM")

    monkeypatch.setattr(tpar, "build_suffix_array_sharded", boom)
    assert cli.main(["banana", "--backend", "sharded", "--devices", "2",
                     "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "STATUS:FAILED" in out
    assert "IMPLEMENTATION:torch_cpu_sharded" in out
