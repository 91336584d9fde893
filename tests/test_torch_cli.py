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
