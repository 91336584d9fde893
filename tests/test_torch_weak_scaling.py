"""The port's weak-scaling runner on the CPU, at a tiny size.

``bench/weak_scaling.py`` sweeps its four builders over P = 1 and 2
shards of the CPU and runs the two-process point through
``bench/weak_scaling_worker.py`` (gloo, a FileStore in the output
directory). The rows must carry the JAX harness's row columns plus the
scaling columns, labelled for what they measure (never ``cpu_mesh``),
and the CSV must read back. ``_append_scaling_rows`` keeps the rows of
an earlier mesh sweep and replaces earlier scaling rows.
"""

import csv

import pytest
import torch

from hpc_suffix_array_tpu_torch.bench import harness, weak_scaling

ROW_KEYS = ["file", "size_bytes", "size_mb", "backend", "platform",
            "processes", "time_seconds", "throughput_mb_s", "sa_time",
            "total_time", "lcp_time", "lrs_time", "compile_time", "builder",
            "success", "error", "scaling_mode", "weak_efficiency",
            "weak_efficiency_normalized"]


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    out = tmp_path_factory.mktemp("weak")
    rows = weak_scaling.main(512, mesh_sizes=(1, 2), out_dir=out,
                             device="cpu", charts=False, verbose=False)
    return out, rows


def test_rows_of_every_builder(runner):
    _out, rows = runner
    builders = [r["builder"] for r in rows]
    assert builders == ["msd"] * 2 + ["msd_lcp"] * 2 + ["msd_wide"] * 2 + [
        "doubling"] * 2 + ["msd_2proc"] * 2
    for r in rows:
        assert all(k in r for k in ROW_KEYS), r
        assert r["success"] is True and r["sa_time"] > 0
        assert r["scaling_mode"] == ("weak_2proc_cpu_gloo"
                                     if r["builder"] == "msd_2proc"
                                     else "weak_one_cpu_shards")
    one = [r for r in rows if r["builder"] == "msd"]
    assert [r["processes"] for r in one] == [1, 2]
    assert [r["size_bytes"] for r in one] == [512, 1024]
    assert one[0]["weak_efficiency_normalized"] == 1.0
    two = [r for r in rows if r["builder"] == "msd_2proc"]
    assert [(r["nprocs"], r["processes"], r["size_bytes"]) for r in two] == [
        (1, 1, 512), (2, 4, 2048)]


def test_csv_and_report_read_back(runner):
    out, rows = runner
    with open(out / "weak_scaling.csv", newline="") as f:
        back = list(csv.DictReader(f))
    assert len(back) == len(rows)
    assert [r["builder"] for r in back] == [r["builder"] for r in rows]
    assert [float(r["sa_time"]) for r in back] == [r["sa_time"] for r in rows]
    text = (out / "weak_scaling.txt").read_text()
    assert "[msd_2proc]" in text and "No interconnect" in text
    assert not list(out.glob("pg_store_*"))


def test_append_scaling_rows_keeps_sweep_rows(tmp_path):
    sweep = {"file": "random_1MB.txt", "backend": "cpu_sharded_2",
             "sa_time": 0.5}
    harness._write_rows(tmp_path / "parallel_results.csv", [sweep])
    first = harness._append_scaling_rows(
        [{"file": "w1", "scaling_mode": "weak_one_cpu_shards"}], tmp_path)
    assert [r["file"] for r in first] == ["random_1MB.txt", "w1"]
    second = harness._append_scaling_rows(
        [{"file": "w2", "scaling_mode": "weak_one_cpu_shards"}], tmp_path)
    assert [r["file"] for r in second] == ["random_1MB.txt", "w2"]


def test_fence_tree_walks_nested_outputs():
    x = torch.zeros(3)
    harness._fence_tree((x, [None, x], ([x],)))          # no error on CPU
    with pytest.raises(ValueError):
        harness.weak_scaling_proxy(builder="bogus", device="cpu")
