"""The configuration ``english-copies``, its cell and the readers of the
refinement's doubling rounds and RangeMin (``refine_doubling_ms``,
``refine_rmq_ms``), on the CPU.

    python -m pytest cellbench/tests -q
"""

import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cellbench import harness  # noqa: E402

BENCH = harness.Bench()
READERS = {"refine_doubling_ms": "refine: doubling",
           "refine_rmq_ms": "refine: rmq"}
CELL = "english-copies.one-1g"


def _build(traced: bool, spans: dict) -> harness.Build:
    b = harness.Build(text=0, n=1, start=0.0, info={"spans_ms": spans})
    b.traced = traced
    return b


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_none_without_its_span(name):
    run = harness.Run(setup_s=1.0, builds=[
        _build(True, {}), _build(False, {"refine: rounds": {"ms": 5.0}})])
    assert BENCH.module("layers", name).read(run) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_gives_the_mean_device_ms_of_its_span(name):
    span = READERS[name]

    def spans(device_ms):
        return {span: {"ms": 99.0, "calls": 3, "device_ms": device_ms}}

    # The traced build is left out; a plain build without the span (no
    # doubling in it) counts 0.
    run = harness.Run(setup_s=1.0, builds=[
        _build(True, spans(1000.0)), _build(False, spans(30.0)),
        _build(False, spans(50.0)), _build(False, {})])
    assert BENCH.module("layers", name).read(run) == pytest.approx(80 / 3)


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_new_reader_is_listed_with_its_cells(name):
    entry = next(m for m in BENCH.spec["per_layer"] if m["name"] == name)
    assert entry["workloads"] == [CELL, "dna.one-200m"]
    assert (entry["unit"], entry["better"], entry["source"],
            entry["moves"]) == ("ms", "lower", "program_span", "index_MBps")


def test_english_copies_is_english_with_the_copy_law():
    cfg, base = BENCH.config("english-copies"), BENCH.config("english")
    params = dict(cfg["generator_params"])
    assert params.pop("copies") == {"share": 0.015, "lo": 65536,
                                    "hi": 1048576}
    del base["generator_params"]["copies"]
    assert params == base["generator_params"]
    for key in ("generator", "published_bytes", "published", "guarantee",
                "reference"):
        assert cfg[key] == base[key], key
    entry = BENCH._entry("configs", "english-copies")
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    cell = BENCH.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "english-copies", "one-1g", 1)


@pytest.mark.parametrize("config,longest", [
    ("english-copies", (1 << 16, 1 << 20)), ("english", (0, 1 << 12))])
def test_a_4_mib_text_holds_a_repeat_of_at_least_64_kib(config, longest):
    """The longest repeat of a 4 MiB text (SA-IS and Kasai): a verbatim
    copy of 64 KiB-1 MiB with the copies, none of 4 KiB without."""
    from hpc_suffix_array_tpu_torch.core.oracle import (
        lcp_oracle, suffix_array_oracle)

    cfg = BENCH.config(config)
    text = BENCH.module("gen", cfg["generator"]).make(
        1 << 22, 2**31 + 29, "cpu", **cfg["generator_params"]).numpy()
    top = int(lcp_oracle(text, suffix_array_oracle(text)).max())
    assert longest[0] <= top < longest[1]
