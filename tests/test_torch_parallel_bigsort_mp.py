"""The port's multi-process carried-keys entry against the JAX package's.

``_present``, ``_period`` and ``_window`` are held against the JAX
package's ``_present_kernel``, ``_period_kernel`` and ``_window_kernel``
on its 8-device CPU mesh (``tests/conftest.py``), in this process, on
the same text and queries. ``build_suffix_array_sharded_big_mp`` runs in
worker processes joined by gloo through a FileStore (2 processes x 2
shards, and 4 x 1), each given only its block of the padded text; the
workers write their local shards of the padded SA and LCP to files, and
the joined arrays must equal SA-IS/Kasai and the JAX package's
``build_suffix_array_sharded_big`` byte for byte, with pad rows n (SA)
and 0 (LCP). Texts the entry refuses must raise NotImplementedError on
every rank, within the run's timeout. Texts are numpy arrays from
fixed seeds.
"""

import functools
import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import hpc_suffix_array_tpu.parallel as jpar
import hpc_suffix_array_tpu.parallel.bigsort as jbig
import hpc_suffix_array_tpu_torch.parallel as tpar
import hpc_suffix_array_tpu_torch.parallel.bigsort as tbig
from hpc_suffix_array_tpu.parallel.mesh import sequence_sharding
from hpc_suffix_array_tpu_torch import native
from hpc_suffix_array_tpu_torch.cli_distributed import run_workers
from hpc_suffix_array_tpu_torch.parallel.mesh import bucket_size, first_local

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEOMETRIES = {"2x2": (2, 2), "4x1": (4, 1)}
ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)
DNA = np.frombuffer(b"ACGT", np.uint8)


def _rng(seed):
    return np.random.default_rng(seed)


def _alnum(n, seed):
    return ALNUM[_rng(seed).integers(0, 62, n)].copy()


def _residue():
    t = _alnum(8 * 1024, 3)
    t[500:600] = t[3000:3100]             # one 100-byte repeat
    t[7000:7040] = t[1000:1040]           # one 40-byte repeat
    return t


def _slot_zero():
    """The smallest suffixes tie through the carried window: a tied
    group at global sorted slot 0."""
    t = _alnum(8 * 1024, 7)
    t[:40] = ord("!")
    t[4000:4040] = ord("!")
    return t


def _dna_min_tail():
    t = DNA[_rng(8).integers(0, 4, 8 * 1024)].copy()
    t[-40:] = ord("A")
    return t


def _odd_n():
    """n not a multiple of P*128 (pad rows in the last shard), with a
    repeat that ends at the text's end."""
    t = _alnum(5003, 4)
    t[-50:] = t[100:150]
    return t


def _deep_tie():
    """One 4,300-byte block copied once: its residue pairs tie past the
    4,096-byte gathered window, which the host-text entry reads past."""
    t = _alnum(32 * 1024, 5)
    t[20_000:24_300] = t[2000:6300]
    return t


def _two_periods():
    """Two periodic halves: non-uniform chain deltas on more than a
    quarter of the text, refused by both packages."""
    return np.concatenate([np.tile(_alnum(7, 13), 600)[:4096],
                           np.tile(_alnum(11, 14), 400)[:4096]])


BUILT = {
    "alnum": lambda: _alnum(8 * 1024, 1),
    "dna": lambda: DNA[_rng(9).integers(0, 4, 8 * 1024)],
    "p1000": lambda: np.tile(_alnum(1000, 10), 9)[:8 * 1024],
    "residue": _residue,
    "slot_zero": _slot_zero,
    "dna_min_tail": _dna_min_tail,
    "odd_n": _odd_n,
}
REFUSED = {"deep_tie": _deep_tie, "two_periods": _two_periods}
WIDE = ["alnum", "p1000", "residue", "dna_min_tail"]
RUNS = ([(name, "narrow") for name in list(BUILT) + list(REFUSED)]
        + [(name, "wide") for name in WIDE])


@functools.cache
def _text(name: str) -> np.ndarray:
    t = np.ascontiguousarray((BUILT | REFUSED)[name]())
    t.setflags(write=False)
    return t


@functools.cache
def _oracles(name: str):
    t = _text(name)
    sa = native.sa_build(t)
    return sa, native.lcp_kasai(t, sa)


@functools.cache
def _jax_big(name: str, p: int):
    sa, lcp = jbig.build_suffix_array_sharded_big(
        _text(name), jpar.make_mesh(p), want_lcp=True)
    return np.asarray(sa), np.asarray(lcp)


WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from hpc_suffix_array_tpu_torch.parallel import bigsort, multihost
from hpc_suffix_array_tpu_torch.parallel.mesh import read_scalar

pid, n_proc, dpp, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4], sys.argv[5])
multihost.initialize_distributed(f"file://{out}/store", n_proc, pid, "cpu")
mesh = multihost.make_global_mesh(dpp, "cpu")
report = {}
for name, variant in json.load(open(f"{data}/runs.json")):
    text = np.load(f"{data}/{name}.npy")
    n = len(text)
    n_pad, start, stop = bigsort.mp_local_geometry(n, mesh)
    block = np.zeros(stop - start, np.uint8)
    take = max(0, min(n, stop) - start)
    block[:take] = text[start:start + take]
    del text                      # this process keeps only its block
    info, reads = {}, read_scalar.reads
    key = f"{name}.{variant}"
    try:
        sa, lcp = bigsort.build_suffix_array_sharded_big_mp(
            block, n, mesh, want_lcp=True, wide_index=variant == "wide",
            info=info)
    except NotImplementedError as e:
        report[key] = {"status": "refused", "why": str(e)}
        continue
    for me in mesh.local_ids:
        np.save(f"{out}/{key}.sa.{me}.npy", sa[me].numpy())
        np.save(f"{out}/{key}.lcp.{me}.npy", lcp[me].numpy())
    report[key] = {"status": "ok", "info": info,
                   "reads": read_scalar.reads - reads,
                   "none": [i for i, x in enumerate(sa) if x is None]}
torch.distributed.destroy_process_group()
with open(f"{out}/rank{pid}.json", "w") as f:
    json.dump(report, f)
"""


def _worker_env() -> dict:
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": str(ROOT) + (
        os.pathsep + path if path else "")}


@pytest.fixture(scope="module")
def mp_runs(tmp_path_factory):
    """Every run of RUNS in both geometries: geometry -> (output dir, the
    ranks' reports)."""
    data = tmp_path_factory.mktemp("texts")
    for name in list(BUILT) + list(REFUSED):
        np.save(data / f"{name}.npy", _text(name))
    (data / "runs.json").write_text(json.dumps(RUNS))
    runs = {}
    for geom, (n_proc, dpp) in GEOMETRIES.items():
        out = tmp_path_factory.mktemp(geom)
        cmds = [[sys.executable, "-c", WORKER, str(r), str(n_proc),
                 str(dpp), str(data), str(out)] for r in range(n_proc)]
        with open(out / "stdout.txt", "w") as log:
            rc = run_workers(cmds, stdout=log, env=_worker_env(),
                             timeout=240)
        reports = ([json.loads((out / f"rank{r}.json").read_text())
                    for r in range(n_proc)] if rc == 0 else None)
        runs[geom] = (out, rc, reports)
    return runs


def _joined(out, key: str, col: str, p: int) -> np.ndarray:
    return np.concatenate([np.load(out / f"{key}.{col}.{me}.npy")
                           for me in range(p)])


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("name,variant",
                         [r for r in RUNS if r[0] in BUILT])
def test_mp_build_equals_oracles_and_jax(mp_runs, geom, name, variant):
    out, rc, reports = mp_runs[geom]
    assert rc == 0
    n_proc, dpp = GEOMETRIES[geom]
    p = n_proc * dpp
    key = f"{name}.{variant}"
    rank_reports = [r[key] for r in reports]
    assert all(r["status"] == "ok" for r in rank_reports), rank_reports
    # Lockstep: every rank took the same attempts and read the same
    # number of reduced stats, one per distributed sort.
    assert all(r["info"] == rank_reports[0]["info"] for r in rank_reports)
    for r, rep in enumerate(rank_reports):
        assert rep["reads"] == rep["info"]["msd_sorts"] >= 1
        assert rep["none"] == [i for i in range(p)
                               if i // dpp != r]
    text = _text(name)
    n = len(text)
    n_pad = bucket_size(n, p * 128)
    sa, lcp = _joined(out, key, "sa", p), _joined(out, key, "lcp", p)
    dtype = np.int64 if variant == "wide" else np.int32
    assert sa.dtype == dtype and lcp.dtype == dtype
    assert sa.shape == lcp.shape == (n_pad,)
    assert (sa[n:] == n).all() and (lcp[n:] == 0).all()
    want_sa, want_lcp = _oracles(name)
    jax_sa, jax_lcp = _jax_big(name, p)
    assert np.array_equal(sa[:n], want_sa)
    assert np.array_equal(sa[:n], jax_sa)
    assert np.array_equal(lcp[:n], want_lcp)
    assert np.array_equal(lcp[:n], jax_lcp)


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_on_every_rank(mp_runs, geom, name):
    """Every rank raises NotImplementedError and none hangs (the run
    ended within its timeout with rc 0). The deep tie is exact on the
    host-text entry, which reads the whole text; the two periods are
    refused there too, as in the JAX package."""
    _out, rc, reports = mp_runs[geom]
    assert rc == 0
    p = GEOMETRIES[geom][0] * GEOMETRIES[geom][1]
    rank_reports = [r[f"{name}.narrow"] for r in reports]
    assert all(r["status"] == "refused" for r in rank_reports), rank_reports
    mesh = tpar.make_mesh(p, devices=["cpu"])
    if name == "deep_tie":
        assert all("tie past 4096 bytes" in r["why"] for r in rank_reports)
        sa, lcp = tbig.build_suffix_array_sharded_big(_text(name), mesh,
                                                      want_lcp=True)
        assert np.array_equal(sa.numpy(), _oracles(name)[0])
        assert np.array_equal(lcp.numpy(), _oracles(name)[1])
    else:
        for build in (tbig.build_suffix_array_sharded_big,
                      jbig.build_suffix_array_sharded_big):
            with pytest.raises(NotImplementedError):
                build(_text(name), mesh if build is tbig.
                      build_suffix_array_sharded_big else jpar.make_mesh(p))


def test_mp_entry_checks_its_block():
    mesh = tpar.make_mesh(2, devices=["cpu"])
    n_pad = tbig.mp_local_geometry(1000, mesh)[0]
    with pytest.raises(ValueError, match="mp_local_geometry"):
        tbig.build_suffix_array_sharded_big_mp(np.zeros(n_pad - 1, np.uint8),
                                               1000, mesh)
    with pytest.raises(ValueError, match="n >= 8"):
        tbig.build_suffix_array_sharded_big_mp(np.zeros(256, np.uint8), 5,
                                               mesh)


# --- the _mp kernels against the JAX package's ------------------------------

def _both(name: str, p: int):
    """(JAX sharded padded text, port sharded padded text, n, n_pad)."""
    text = _text(name)
    n = len(text)
    n_pad = bucket_size(n, p * 128)
    pad = np.zeros(n_pad, np.uint8)
    pad[:n] = text
    jmesh = jpar.make_mesh(p)
    text_d = jax.device_put(pad, sequence_sharding(jmesh))
    texts = tpar.doubling.padded_shards(text, n_pad,
                                        tpar.make_mesh(p, devices=["cpu"]))
    return jmesh, text_d, texts, n, n_pad


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("name", ["alnum", "dna", "odd_n", "dna_min_tail"])
def test_present_matches_jax_kernel(name, p):
    jmesh, text_d, texts, n, n_pad = _both(name, p)
    m = n_pad // p
    want = np.asarray(jbig._present_kernel(jmesh)(
        text_d, jnp.int32(n // m), jnp.int32(n % m)))
    got = tbig._present(texts, n)
    assert all(g.tolist() == want.tolist() for g in got)
    assert (want > 0).sum() == len(np.unique(_text(name)))


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("name", ["p1000", "residue", "odd_n"])
def test_period_matches_jax_kernel(name, p):
    jmesh, text_d, texts, n, n_pad = _both(name, p)
    m = n_pad // p
    kern = jbig._period_kernel(jmesh)
    for d in (1, 7, 999, 1000, 2000, m - 1, m, m + 3, 3 * m + 1, n - 1, n):
        if d >= n_pad:
            continue
        want = int(kern(text_d, jnp.int32(d // m), jnp.int32(d % m),
                        jnp.int32(n // m), jnp.int32(n % m)))
        got = tbig._period(texts, d, n)
        assert all(int(g) == want for g in got), (d, want)
        holds = d >= n or not np.any(_text(name)[:-d] != _text(name)[d:])
        assert (want == 0) == holds, d


@pytest.mark.parametrize("p", [2, 8])
@pytest.mark.parametrize("W", [64, 4096])
def test_window_matches_jax_kernel(W, p):
    jmesh, text_d, texts, n, n_pad = _both("odd_n", p)
    m = n_pad // p
    RW = min(W, m & -m)
    idxs = np.array([0, 1, 127, 128, m - 1, m, n - 70, n - 1, 2000, 4999],
                    np.int64)
    q, off = (idxs // RW).astype(np.int32), (idxs % RW).astype(np.int32)
    want = np.asarray(jbig._window_kernel(jmesh, W, len(idxs), RW)(
        text_d, jnp.asarray(q), jnp.asarray(off)))
    got = tbig._window(texts, q, off, W, RW)
    assert all(np.array_equal(g.numpy(), want) for g in got)
    win = first_local(got).numpy()
    for i, at in enumerate(idxs):          # the real bytes, then pads
        real = _text("odd_n")[at:at + W]
        assert np.array_equal(win[i, :len(real)], real)
