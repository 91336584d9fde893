"""The benchmark's files and its result line, on the CPU.

    python -m pytest cellbench/tests -q
"""

import json
import pathlib
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cellbench import harness, traffic  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_bench(tmp_path, sizes=None) -> harness.Bench:
    """A copy of the benchmark whose traffic files hold tiny texts."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    law = sizes or {"law": "log_uniform", "lo": 1000, "hi": 30000,
                    "count": 4, "round": 100}
    for path in (tmp_path / "cellbench" / "traffic").glob("*.json"):
        tr = json.loads(path.read_text())
        tr["sizes"] = law
        tr["trace_builds"] = 2
        path.write_text(json.dumps(tr))
    return harness.Bench(tmp_path / "cellbench")


@pytest.fixture
def small_routes(monkeypatch):
    """Thresholds lowered so that tiny texts take every route."""
    for key, value in {"SA_BIG_THRESHOLD": 10000, "SA_CHAIN_MIN": 10000,
                       "SA_LCP_WINDOW_MIN": 12000,
                       "SA_LCP_BIG_MIN": 25000}.items():
        monkeypatch.setenv(key, str(value))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    bench = harness.Bench()
    entry = bench.cell(cell)
    config = bench.config(entry["config"])
    tr = bench.traffic(entry["traffic"])
    assert callable(bench.module("gen", config["generator"]).make)
    assert traffic.sizes(tr) and sorted(traffic.order(tr, 7, 3)) == [0, 1, 2]
    for traced in (False, True):
        for m in bench.metrics(cell, traced):
            assert callable(bench.module("layers" if traced else "e2e",
                                         m["name"]).read)


def test_the_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [w["name"] for w in SPEC["workloads"]]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", names)) <= set(names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def test_a_new_cell_is_only_new_files(tmp_path):
    bench = tiny_bench(tmp_path)
    root = bench.dir
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "abc.json").write_text(json.dumps(
        {"generator": "abc", "generator_params": {"letters": "ab"}}))
    (root / "gen" / "abc.py").write_text(textwrap.dedent('''
        import torch

        def make(n, seed, device, letters):
            g = torch.Generator(device=device).manual_seed(seed)
            lut = torch.tensor(list(letters.encode()), dtype=torch.uint8)
            return lut[torch.randint(0, len(letters), (n,), generator=g)]
        '''))
    (root / "traffic" / "few.json").write_text(json.dumps(
        {"sizes": {"law": "fixed", "bytes": 3000, "count": 2},
         "order": "cycle", "check_per_route": 1, "trace_builds": 1}))
    (root / "layers" / "builds_seen.py").write_text(
        "def read(run):\n    return float(len(run.builds))\n")
    spec = json.loads((bench.root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "abc", "source": "https://example.org",
                            "file": "cellbench/configs/abc.json",
                            "reduced": [], "why": "two letters"})
    spec["workloads"].append({"name": "abc.few", "config": "abc",
                              "traffic": "few", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "builds_seen", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "harness", "moves": "index_MBps",
                              "workloads": ["abc.few"]})
    (bench.root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(root)
    result, _ = harness.run_cell(bench, "abc.few", 5, 0.2, True, "cpu",
                                 time.perf_counter())
    assert result["correct"]
    assert result["metrics"]["builds_seen"]["value"] == result["attempted"]
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_the_result_line_has_the_contract_keys(tmp_path, small_routes):
    bench = tiny_bench(tmp_path)
    for traced in (False, True):
        result, checked = harness.run_cell(
            bench, "dna.one-200m", 2**31 + 11, 0.3, traced, "cpu",
            time.perf_counter())
        assert list(result) == CONTRACT_KEYS + ["checks"]
        assert set(result["device"]) == {"platform", "kind", "count",
                                         "memory_peak_bytes"}
        assert result["correct"] and result["failed"] == 0 and checked
        wanted = {m["name"] for m in bench.metrics("dna.one-200m", traced)}
        # The CPU has no device trace: its metrics are left out.
        assert set(result["metrics"]) <= wanted
        for m in result["metrics"].values():
            assert set(m) == {"value", "unit"}
        for c in result["checks"].values():
            assert c["value"] <= c["limit"]
        json.dumps(result)


def test_a_run_loads_no_jax(tmp_path):
    bench = tiny_bench(tmp_path)
    code = textwrap.dedent(f'''
        import sys, time
        sys.path.insert(0, {str(ROOT)!r})
        import cellbench.run
        from cellbench import harness
        bench = harness.Bench({str(bench.dir)!r})
        harness.run_cell(bench, "english.one-1g", 3, 0.2, False, "cpu",
                         time.perf_counter())
        names = {{m.split(".")[0] for m in sys.modules}}
        print(sorted(names & {{"jax", "jaxlib", "flax",
                               "hpc_suffix_array_tpu"}}))
        print("hpc_suffix_array_tpu_torch" in names)
        ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    assert out.split("\n")[:2] == ["[]", "True"]


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "hpc_suffix_array_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "hpc_suffix_array_tpu.core", sys)
    assert harness.banned_modules() == ["hpc_suffix_array_tpu"]


def test_run_py_refuses_without_a_card(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload", "dna.one-200m",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_the_seed_makes_the_texts(config):
    bench = harness.Bench()
    cfg = bench.config(config)
    gen = bench.module("gen", cfg["generator"])
    tr = {"sizes": {"law": "fixed", "bytes": 20000, "count": 2}}
    a, b, c = (traffic.make_pool(tr, gen.make, s, "cpu",
                                 **cfg["generator_params"])
               for s in (2**31 + 5, 2**31 + 5, 2**31 + 6))
    assert all((x == y).all() for x, y in zip(a, b))
    assert not (a[0] == a[1]).all() and not (a[0] == c[0]).all()


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_a_made_text_has_the_published_statistics(config):
    """The symbols the generator can make number the published alphabet
    size, and a 4 MiB text's inverse match probability (1 / sum p**2
    over its byte frequencies) is the published one within 1%."""
    bench = harness.Bench()
    cfg = bench.config(config)
    gen = bench.module("gen", cfg["generator"])
    params = cfg["generator_params"]
    if cfg["generator"] == "english":
        can = set(np.unique(gen.cells(**{
            k: params[k] for k in ("vocab_octaves", "vocab_seed",
                                   "octave_len", "letters", "letter_weights",
                                   "separators", "rare")})[0])) - {0}
    else:
        can = set(params["symbols"]) | {params["runs"]["symbol"]}
    assert len(can) == cfg["published"]["alphabet_size"]
    text = gen.make(1 << 22, 2**31 + 9, "cpu", **params).numpy()
    p = np.bincount(text, minlength=256) / len(text)
    assert 1 / (p * p).sum() == pytest.approx(
        cfg["published"]["inverse_match_probability"], rel=0.01)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    """One short run of the smallest cell through ``run.py``, on a card."""
    if not __import__("torch").cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "cellbench/run.py", "--workload",
         "dna.one-200m", "--seed", "2147483659", "--seconds", "2",
         "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().split("\n")[-1])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert proc.stderr.strip().split("\n")[-1].startswith("check ")
