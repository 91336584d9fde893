"""The check that decides ``correct``, its control and its faults, the
harness's calls against the CLI's, and the trace arithmetic, on the CPU.

    python -m pytest cellbench/tests -q
"""

import io
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cellbench import control, devtrace, harness, reference  # noqa: E402
from cellbench.tests.test_cellbench_spec import (  # noqa: E402
    small_routes, tiny_bench)

BENCH = harness.Bench()


def made(config: str, n: int, seed: int) -> np.ndarray:
    """A text of configuration ``config`` as its generator makes it."""
    cfg = BENCH.config(config)
    gen = BENCH.module("gen", cfg["generator"])
    return gen.make(n, seed, "cpu", **cfg["generator_params"]).numpy()


def naive(text: bytes):
    """SA, LCP and LRS by sorting the suffixes themselves."""
    n = len(text)
    sa = sorted(range(n), key=lambda i: text[i:])
    lcp = [0] * n
    for j in range(1, n):
        a, b = text[sa[j - 1]:], text[sa[j]:]
        while lcp[j] < min(len(a), len(b)) and a[lcp[j]] == b[lcp[j]]:
            lcp[j] += 1
    top = max(lcp, default=0)
    lrs = text[sa[lcp.index(top)]:][:top] if top else None
    return np.array(sa, np.int32), np.array(lcp, np.int32), lrs


def port(text: np.ndarray):
    b = harness.build_once(harness.port_api(), text, torch.device("cpu"))
    return b.outputs


def texts():
    yield "banana", np.frombuffer(b"banana", np.uint8)
    yield "aaaa", np.frombuffer(b"a" * 300, np.uint8)
    yield "abab", np.frombuffer(b"ab" * 150 + b"a", np.uint8)
    yield "english", made("english", 3000, 11)
    yield "dna", made("dna", 3000, 12)


@pytest.mark.parametrize("name,text", list(texts()))
def test_the_reference_passes_the_exact_answer(name, text):
    sa, lcp, lrs = naive(text.tobytes())
    assert reference.judge(text, sa, lcp, lrs, "cpu") == {
        "sa_bad": 0, "lcp_bad": 0, "lrs_bad": 0}
    psa, plcp, plrs = port(text)
    assert np.array_equal(psa.numpy(), sa)
    assert np.array_equal(plcp.numpy(), lcp)
    assert len(plrs or b"") == len(lrs or b"")
    assert reference.judge(text, psa, plcp, plrs, "cpu") == {
        "sa_bad": 0, "lcp_bad": 0, "lrs_bad": 0}


def _swap(sa, lcp, lrs):
    sa = sa.copy()
    sa[[3, 4]] = sa[[4, 3]]
    return sa, lcp, lrs


def _lcp_up(sa, lcp, lrs):
    lcp = lcp.copy()
    lcp[len(lcp) // 2] += 1
    return sa, lcp, lrs


def _lcp_down(sa, lcp, lrs):
    lcp = lcp.copy()
    j = int(np.argmax(lcp))
    lcp[j] -= 1
    return sa, lcp, lrs


def _lrs_short(sa, lcp, lrs):
    return sa, lcp, lrs[:-1]


def _lrs_wrong(sa, lcp, lrs):
    return sa, lcp, lrs[:-1] + b"#"


@pytest.mark.parametrize("fault,number", [
    (_swap, "sa_bad"), (_lcp_up, "lcp_bad"), (_lcp_down, "lcp_bad"),
    (_lrs_short, "lrs_bad"), (_lrs_wrong, "lrs_bad")])
@pytest.mark.parametrize("name", ["english", "dna", "abab"])
def test_the_reference_counts_an_altered_answer(fault, number, name):
    text = dict(texts())[name]
    got = reference.judge(text, *fault(*naive(text.tobytes())), "cpu")
    assert got[number] > 0


def test_the_control_is_not_correct():
    """The control at a test size: repeated runs of words tie deeper
    than its 16 bytes."""
    text = made("english", 1 << 19, 5)
    got = reference.judge(text, *control.bounded_depth(text, "cpu"), "cpu")
    assert got["sa_bad"] > 0 and got["lcp_bad"] > 0


def test_the_control_is_exact_where_no_tie_is_deep():
    text = np.frombuffer(b"mississippi", np.uint8)
    sa, lcp, lrs = control.bounded_depth(text, "cpu")
    esa, elcp, elrs = naive(text.tobytes())
    assert np.array_equal(sa.numpy(), esa) and lrs == elrs
    assert np.array_equal(lcp.numpy(), elcp)


class Faulty:
    """The port's calls with one fault planted where the answer is made."""

    def __init__(self, kind: str):
        self.kind, self.api, self.last = kind, harness.port_api(), None

    def build(self, text, *, device, info, text_dev):
        if self.kind == "half":       # half of the text left out
            half = len(text) // 2
            return self.api.build(text[:half], device=device, info=info)
        sa, lcp = self.api.build(text, device=device, info=info,
                                 text_dev=text_dev)
        if self.kind == "stale":      # the previous build's answer again
            out, self.last = self.last or (sa, lcp), (sa, lcp)
            return out
        if self.kind == "sa":
            sa = sa.clone()
            sa[[1, 2]] = sa[[2, 1]]
        if self.kind == "lcp":
            lcp = lcp.clone()
            lcp[len(lcp) // 3] += 1
        return sa, lcp

    def lrs(self, t, sa, lcp, *, device):
        got = self.api.lrs(t, sa[:t.shape[0]], lcp[:t.shape[0]],
                           device=device)
        return got[:-1] if self.kind == "lrs" else got

    def as_api(self):
        return harness.PortAPI(self.api.stage, self.build, self.lrs)


@pytest.mark.parametrize("cell", ["english.one-1g", "dna.one-200m"])
@pytest.mark.parametrize("kind", ["stale", "half", "sa", "lcp", "lrs"])
def test_a_run_with_a_fault_is_not_correct(tmp_path, small_routes, cell,
                                           kind):
    sizes = ({"law": "fixed", "bytes": 6000, "count": 2}
             if cell.startswith("english") else None)
    bench = tiny_bench(tmp_path, sizes)
    result, _ = harness.run_cell(bench, cell, 99, 0.3, False, "cpu",
                                 time.perf_counter(),
                                 api=Faulty(kind).as_api())
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_sound_run_of_the_same_cells_is_correct(tmp_path, small_routes):
    bench = tiny_bench(tmp_path, {"law": "fixed", "bytes": 6000, "count": 2})
    result, checked = harness.run_cell(bench, "english.one-1g", 99, 0.3,
                                       False, "cpu", time.perf_counter())
    assert result["correct"] and len(checked) == 1


def test_the_harness_builds_as_the_cli_does(small_routes):
    """The window's three calls give the CLI's routes, SA and LCP, on
    texts of each route."""
    from hpc_suffix_array_tpu_torch import cli

    api, cpu = harness.port_api(), torch.device("cpu")
    routes = set()
    for config, n in [("english", 5000), ("dna", 5000), ("dna", 15000),
                      ("english", 15000), ("dna", 40000),
                      ("english", 40000)]:
        text = made(config, n, n)
        b = harness.build_once(api, text, cpu)
        arrays = {}
        res = cli.run(text, "t", "cpu", validate=False, dialect="sequential",
                      out=io.StringIO(), arrays=arrays)
        assert b.info.get("path") == res.get("path")
        assert b.info.get("lcp_path") == res.get("lcp_path")
        assert torch.equal(b.outputs[0], arrays["sa"])
        assert torch.equal(b.outputs[1], arrays["lcp"])
        assert len(b.outputs[2] or b"") == res["lrs_length"]
        routes.add(b.route)
    assert {"doubling+plcp", "direct+sorted", "direct+fused"} <= routes


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_the_trace_arithmetic_is_the_ports():
    from hpc_suffix_array_tpu_torch.utils.profiling import device_busy

    events = [
        _event("kernel", "pack_words_kernel(unsigned char const*)", 0, 10),
        _event("kernel", "void at::native::sort<int>(int)", 5, 10),
        _event("gpu_memcpy", "Memcpy HtoD", 30, 5),
        _event("kernel", "onesweep_pass_kernel(Cols, int)", 50, 20),
        _event("user_annotation", "cellbench: sa_lcp", 0, 70),
        _event("cpu_op", "aten::item", 16, 12),
        _event("cuda_runtime", "cudaLaunchKernel", 40, 2),
        _event("user_annotation", "PyTorch Profiler (0)", 0, 80),
    ]
    got = devtrace.summarize(events, 2)
    ref = device_busy(events)
    assert got["window_s"] * 1e3 == pytest.approx(ref["window_ms"])
    assert got["busy_s"] * 1e3 == pytest.approx(ref["busy_ms"])
    assert got["idle_share"] == pytest.approx(ref["idle_share"])
    assert got["busy_s"] == pytest.approx(40e-6)
    assert set(got["kernels"]) == {e["name"] for e in events[:4]
                                   if e["cat"] == "kernel"}
    gaps = got["breakdown"]["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([15e-6, 15e-6])
    assert gaps[0][0] == "aten::item" or gaps[1][0] == "aten::item"
    assert devtrace.summarize(events[4:], 1) is None


def test_the_readers_split_the_kernels():
    run = harness.Run(setup_s=1.0, builds=[], trace=devtrace.summarize([
        _event("kernel", "void (anonymous namespace)::pack_words_kernel<2, "
               "0>(unsigned char const*)", 0, 1000),
        _event("kernel", "(anonymous namespace)::onesweep_pass_kernel("
               "sa_radix::Cols, int)", 1000, 2000),
        _event("kernel", "(anonymous namespace)::digit_histograms_kernel("
               "Words)", 3000, 500),
        _event("kernel", "void at_cuda_detail::cub::DeviceRadixSortOnesweep"
               "Kernel<int>(int)", 3500, 500),
        _event("kernel", "void at::native::(anonymous namespace)::x<int>("
               "int)", 4000, 4000),
    ], 2))
    bench = harness.Bench()
    read = {m: bench.module("layers", m).read(run) for m in
            ("k1_ms", "onesweep_ms", "torch_ops_ms", "kernel_launches",
             "idle_pct", "device_busy_ms")}
    assert read == pytest.approx({"k1_ms": 0.5, "onesweep_ms": 1.25,
                                  "torch_ops_ms": 2.25,
                                  "kernel_launches": 2.5, "idle_pct": 0,
                                  "device_busy_ms": 4.0})
