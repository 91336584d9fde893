"""The port's phase timers, device trace and file I/O helpers.

``phase_timer`` mirrors the JAX package's (``tests/test_utils.py``): it
accumulates per name and fences. On the CPU the default fence is a no-op,
so the fencing is shown with a counting fence. ``device_trace`` on the
CPU writes a Chrome trace with no device events; the case that needs
device events is marked ``cuda``.
"""

import json
import time

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu.utils.io as jio
import hpc_suffix_array_tpu.utils.profiling as jprof
import hpc_suffix_array_tpu_torch.utils.io as tio
from hpc_suffix_array_tpu_torch import cli as tcli
from hpc_suffix_array_tpu_torch.utils.profiling import (
    TRACE_NAME, PhaseTimings, device_busy, device_trace, phase_timer,
    read_trace)


def test_phase_timer_accumulates():
    t = PhaseTimings()
    with phase_timer(t, "alpha", "cpu"):
        time.sleep(0.01)
    first = t["alpha"]
    with phase_timer(t, "alpha", "cpu"):
        time.sleep(0.01)
    with phase_timer(t, "beta", "cpu"):
        pass
    assert list(t) == ["alpha", "beta"]
    assert t["alpha"] >= first + 0.01 > 0.01 and t["beta"] >= 0
    report = t.report()
    assert "alpha" in report and "total" in report


def test_phase_timings_report_equals_jax():
    values = {"sa_build": 1.25, "lcp_build": 0.5, "lrs_search": 0.001}
    assert PhaseTimings(values).report() == jprof.PhaseTimings(values).report()
    assert PhaseTimings().report() == jprof.PhaseTimings().report()


def test_phase_timer_fences_both_ends_and_on_error():
    t = PhaseTimings()
    calls = []

    def fence():
        calls.append(time.perf_counter())

    with phase_timer(t, "alpha", "cpu", fence=fence):
        assert len(calls) == 1            # the start is fenced before t0
        inside = time.perf_counter()
    assert len(calls) == 2 and calls[0] <= inside <= calls[1]
    with pytest.raises(KeyError):
        with phase_timer(t, "broken", "cpu", fence=fence):
            raise KeyError("x")
    assert len(calls) == 4 and "broken" in t


def test_phase_timer_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        with phase_timer(PhaseTimings(), "alpha", "cuda"):
            pass


def test_device_trace_on_cpu_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path / "tr", "cpu") as prof:
        x = torch.arange(1 << 12).flip(0).sort().values
    assert int(x[0]) == 0
    assert (tmp_path / "tr" / TRACE_NAME).stat().st_size > 0
    events = read_trace(tmp_path / "tr")
    assert any("sort" in e["name"] for e in events)
    assert any("sort" in e.key for e in prof.key_averages())
    with pytest.raises(ValueError, match="no device event"):
        device_busy(events)


def test_device_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with device_trace(tmp_path, "cpu"):
            torch.arange(10).sum()
            1 / 0
    assert json.loads((tmp_path / TRACE_NAME).read_text())["traceEvents"]


def test_device_busy_merges_overlaps_and_ranks_gaps():
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        ev("kernel", "k_a", 100, 50), ev("kernel", "k_b", 120, 10),
        ev("kernel", "k_a", 140, 20),              # overlaps the first
        ev("gpu_memcpy", "Memcpy DtoH", 400, 100),  # after a 240 us gap
        ev("kernel", "k_b", 520, 80),               # after a 20 us gap
        ev("cpu_op", "aten::item", 150, 260),
        ev("cuda_runtime", "cudaStreamSynchronize", 390, 120),
        ev("user_annotation", "PyTorch Profiler (0)", 0, 1000),
    ]
    got = device_busy(events, n_top=2, n_gaps=2)
    assert got["n_events"] == 5
    assert got["window_ms"] == pytest.approx(0.5)
    assert got["busy_ms"] == pytest.approx(0.24)
    assert got["idle_share"] == pytest.approx(0.52)
    assert got["top"] == [{"name": "Memcpy DtoH", "ms": 0.1, "count": 1},
                          {"name": "k_b", "ms": 0.09, "count": 2}]
    first, second = got["gaps"]
    assert (first["ms"], first["at_ms"]) == (0.24, 0.06)
    assert (first["after"], first["before"]) == ("k_a", "Memcpy DtoH")
    assert first["host"][0] == {"name": "aten::item", "ms": 0.24}
    assert first["host"][1] == {"name": "cudaStreamSynchronize", "ms": 0.01}
    assert (second["ms"], second["after"], second["before"]) == (
        0.02, "Memcpy DtoH", "k_b")


def test_cli_trace_flag(tmp_path, capsys):
    d = tmp_path / "trace"
    assert tcli.main(["banana", "--device", "cpu", "--trace", str(d)]) == 0
    out = capsys.readouterr().out
    assert f"device trace written to {d}" in out
    assert "Valid suffix array: YES" in out
    assert out.index("===END_RESULTS===") < out.index("device trace written")
    assert (d / TRACE_NAME).stat().st_size > 0


def test_cli_trace_failure_still_ends_in_the_failed_block(
        tmp_path, capsys, monkeypatch):
    import hpc_suffix_array_tpu_torch.core.suffix_array as sa_mod

    def boom(*a, **k):
        raise RuntimeError("injected for test")

    monkeypatch.setattr(sa_mod, "build_suffix_array", boom)
    d = tmp_path / "trace"
    assert tcli.main(["banana", "--device", "cpu", "--trace", str(d)]) == 1
    out = capsys.readouterr()
    assert "STATUS:FAILED" in out.out and "ERROR:RuntimeError" in out.out
    assert "device trace written" not in out.out
    assert "build failed" in out.err


@pytest.mark.cuda
def test_device_trace_holds_cuda_events(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CPU trace has no device events")
    from hpc_suffix_array_tpu_torch import build_sa_lcp
    from hpc_suffix_array_tpu_torch.datasets import generate_random_text

    text = generate_random_text(1 << 24, 0)
    build_sa_lcp(text, device="cuda")                   # warm-up
    with device_trace(tmp_path, "cuda"):
        build_sa_lcp(text, device="cuda")
    events = read_trace(tmp_path)
    names = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any("onesweep_pass" in n for n in names)
    assert any("pack_words" in n for n in names)
    busy = device_busy(events)
    assert 0 < busy["busy_ms"] <= busy["window_ms"]
    assert 0 <= busy["idle_share"] < 1


# --- utils/io.py ----------------------------------------------------------

def test_read_and_write_file_match_jax(tmp_path):
    data = np.random.default_rng(0).integers(0, 256, 5000).astype(np.uint8)
    tio.write_file(tmp_path / "t.bin", data)
    jio.write_file(tmp_path / "j.bin", data)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
    tio.write_file(tmp_path / "b.bin", b"banana")
    assert (tmp_path / "b.bin").read_bytes() == b"banana"
    for mmap in (True, False):
        got = tio.read_file(str(tmp_path / "t.bin"), mmap=mmap)
        assert got.dtype == np.uint8 and np.array_equal(got, data)
        assert np.array_equal(got, jio.read_file(str(tmp_path / "j.bin"),
                                                 mmap=mmap))
    assert isinstance(tio.read_file(str(tmp_path / "t.bin")), np.memmap)
    (tmp_path / "empty").write_bytes(b"")
    assert tio.read_file(str(tmp_path / "empty")).shape == (0,)
    with pytest.raises(OSError):
        tio.read_file(str(tmp_path / "missing"))


@pytest.mark.parametrize("data", [
    b"mississippi river", np.frombuffer(b"abc\xff\xfe tail", np.uint8),
    b"ab"])
def test_previews_match_jax(data, capsys):
    for n in (3, 50):
        tio.print_first_chars(data, n)
        tio.print_last_chars(data, n)
        got = capsys.readouterr().out
        jio.print_first_chars(data, n)
        jio.print_last_chars(data, n)
        assert got == capsys.readouterr().out
        assert got.startswith(f"First {n} characters: ")


def test_cli_file_preview_lines(tmp_path, capsys):
    p = tmp_path / "long.txt"
    p.write_bytes(bytes(range(65, 91)) * 8)
    assert tcli.main([str(p), "--device", "cpu", "--no-validate"]) == 0
    out = capsys.readouterr().out
    assert f"Actual string length: {26 * 8}" in out
    assert ("First 50 characters: "
            + (bytes(range(65, 91)) * 2).decode()[:50] + "\n") in out
    assert ("Last 50 characters: "
            + (bytes(range(65, 91)) * 8).decode()[-50:] + "\n") in out
    q = tmp_path / "short.txt"
    q.write_bytes(b"banana")
    assert tcli.main([str(q), "--device", "cpu", "--no-validate"]) == 0
    assert 'Full content: "banana"' in capsys.readouterr().out


def test_trace_names_the_host_only_planning_steps(tmp_path, monkeypatch):
    """numpy planning shows in a trace through its spans (they explain
    the device's longest idle gaps on the card)."""
    from hpc_suffix_array_tpu_torch import build_sa_lcp
    from hpc_suffix_array_tpu_torch.datasets import generate_random_text

    for key, value in (("SA_BIG_THRESHOLD", "1000"),
                       ("SA_LCP_BIG_MIN", "1000"), ("SA_DIRECT_CROSS", "0"),
                       ("SA_CHUNK_ELEMS", "4096"),
                       ("SA_TARGET_BUCKET", "4096")):
        monkeypatch.setenv(key, value)
    info: dict = {}
    with device_trace(tmp_path, "cpu"):
        build_sa_lcp(generate_random_text(40_000, 0), device="cpu",
                     info=info)
    assert info["path"] == "msd"
    spans = {e["name"] for e in read_trace(tmp_path)
             if e.get("cat") == "user_annotation"}
    assert {"host: estimate_repeat_len", "host: sample_edges"} <= spans
