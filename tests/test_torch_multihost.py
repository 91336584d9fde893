"""The port's multi-process mesh: geometry and cross-process collectives.

The geometry (``host_local_shard``, ``mp_local_geometry``) is checked in
this process, against the JAX package's on the 8-device CPU mesh of
``tests/conftest.py``. The collectives run in worker processes joined
by gloo through a FileStore in ``tmp_path`` (2 processes x 2 shards and
4 x 1), each holding only its own shards; every worker also computes
the single-process list form of each collective from the whole seeded
input and requires its local shards of the cross-process result to
equal it exactly.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest

import hpc_suffix_array_tpu.parallel as jpar
import hpc_suffix_array_tpu.parallel.bigsort as jbig
from hpc_suffix_array_tpu_torch.cli_distributed import run_workers
from hpc_suffix_array_tpu_torch.parallel.bigsort import mp_local_geometry
from hpc_suffix_array_tpu_torch.parallel.mesh import Mesh, shard
from hpc_suffix_array_tpu_torch.parallel.multihost import (
    host_local_shard, make_global_mesh, put_sharded_text)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GEOMETRIES = [(2, 2), (4, 1)]            # (processes, shards per process)
LENGTHS = [8, 100, 1000, 4096, 5003, 65_536, 100_000, 1 << 20, 3 << 20]


def worker_env() -> dict:
    """The environment of a worker process: this checkout importable."""
    path = os.environ.get("PYTHONPATH")
    return {**os.environ, "PYTHONPATH": str(ROOT) + (
        os.pathsep + path if path else "")}


def _mesh(n_proc: int, dpp: int, rank: int) -> Mesh:
    return Mesh(n_proc * dpp, ["cpu"], process_index=rank,
                process_count=n_proc)


@pytest.mark.parametrize("n", LENGTHS)
def test_mp_local_geometry_matches_jax(n):
    """n_pad equals the JAX package's on its 8-device mesh; its one
    process owns [0, n_pad), as a one-process port mesh of 8 shards."""
    j_pad, j_start, j_stop = jbig.mp_local_geometry(n, jpar.make_mesh(8))
    assert mp_local_geometry(n, _mesh(1, 8, 0)) == (j_pad, j_start, j_stop)
    assert (j_start, j_stop) == (0, j_pad)


@pytest.mark.parametrize("n_proc,dpp", GEOMETRIES + [(8, 1), (2, 4)])
@pytest.mark.parametrize("n", LENGTHS)
def test_blocks_of_the_processes_tile_the_padded_text(n, n_proc, dpp):
    j_pad = jbig.mp_local_geometry(n, jpar.make_mesh(n_proc * dpp))[0]
    spans = []
    for r in range(n_proc):
        mesh = _mesh(n_proc, dpp, r)
        n_pad, start, stop = mp_local_geometry(n, mesh)
        assert n_pad == j_pad
        assert host_local_shard(n_pad, mesh) == (start, stop)
        assert mesh.local_ids == list(range(r * dpp, (r + 1) * dpp))
        spans.append((start, stop))
    m = j_pad // (n_proc * dpp)
    assert spans == [(r * dpp * m, (r + 1) * dpp * m) for r in range(n_proc)]


def test_shard_places_only_local_shards():
    text = np.arange(64, dtype=np.uint8)
    got = put_sharded_text(text, _mesh(2, 2, 1))
    assert got[0] is None and got[1] is None
    assert got[2].tolist() == list(range(32, 48))
    assert got[3].tolist() == list(range(48, 64))
    assert [x is None for x in shard(text, _mesh(4, 1, 0))] == [
        False, True, True, True]
    with pytest.raises(ValueError):
        put_sharded_text(text.astype(np.int32), _mesh(2, 2, 0))


def test_mesh_checks_its_processes():
    with pytest.raises(ValueError):
        Mesh(4, ["cpu"], process_index=0, process_count=3)
    with pytest.raises(ValueError):
        Mesh(4, ["cpu"], process_index=2, process_count=2)
    mesh = make_global_mesh(4, "cpu")          # no process group: alone
    assert (mesh.size, mesh.process_count, mesh.local_ids) == (
        4, 1, [0, 1, 2, 3])


WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from hpc_suffix_array_tpu_torch.parallel import gather, multihost
from hpc_suffix_array_tpu_torch.parallel import mesh as M
from hpc_suffix_array_tpu_torch.parallel.bitonic import block_bitonic_sort
from hpc_suffix_array_tpu_torch.parallel.rerank import dist_rerank_multi
from hpc_suffix_array_tpu_torch.parallel.shift import dist_shifted_ranks

pid, n_proc, dpp, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4], sys.argv[5])
multihost.initialize_distributed("file://" + store, n_proc, pid, "cpu")
mesh = multihost.make_global_mesh(dpp, "cpu")
P, mine = mesh.size, mesh.local_ids
rng = np.random.default_rng(7)
checked = []

def part(full):
    return [x if i in mine else None for i, x in enumerate(full)]

def same(name, got, want):
    for i in range(P):
        if i in mine:
            g, w = got[i], want[i]
            assert g.dtype == w.dtype and torch.equal(g, w), (name, i, g, w)
        else:
            assert got[i] is None, (name, i)
    checked.append(name)

def ints(shape, hi=1000, dtype=torch.int32):
    return [torch.as_tensor(rng.integers(0, hi, shape)).to(dtype)
            for _ in range(P)]

x = ints((5, 3))
perms = {"ring": [(i, (i + 1) % P) for i in range(P)],
         "missing": [(i, i + 1) for i in range(P - 1)],
         "partner1": [(i, i ^ 1) for i in range(P)],
         "partner2": [(i, i ^ (P // 2)) for i in range(P)],
         "one_pair": [(P - 1, 0)]}
for name, perm in perms.items():
    same("ppermute_" + name, M.ppermute(part(x), perm), M.ppermute(x, perm))
u8 = ints((7,), 256, torch.uint8)
same("ppermute_u8", M.ppermute(part(u8), perms["ring"]),
     M.ppermute(u8, perms["ring"]))
same("all_gather", M.all_gather(part(x)), M.all_gather(x))
for f in (M.psum, M.pmax, M.pmin):
    same(f.__name__, f(part(x)), f(x))
    s = [t[0, 0] for t in x]
    same(f.__name__ + "_scalar", f(part(s)), f(s))
a = ints((P, 4, 2))
same("all_to_all", M.all_to_all(part(a)), M.all_to_all(a))
ragged = [torch.arange(i + 3, dtype=torch.int64) * (i + 1) for i in range(P)]
assert torch.equal(M.unshard(part(ragged)), M.unshard(ragged))
checked.append("unshard_ragged")
reads = M.read_scalar.reads
assert M.read_scalar(M.first_local(M.psum(part(x)))) == M.psum(x)[0].tolist()
assert M.read_scalar.reads == reads + 1
checked.append("read_scalar")

m = 16
vals = ints((m,), 10_000)
idx = ints((11,), P * m + 6)
idx[0][0] = -3                                   # out of range: the fill
for routed in (False, True):
    gather.ROUTED_MIN_SHARDS = 1 if routed else 1 << 30
    same(f"dist_gather_routed={routed}",
         gather.dist_gather(part(vals), part(idx), fill=-5),
         gather.dist_gather(vals, idx, fill=-5))
dest = torch.as_tensor(rng.permutation(P * m)).to(torch.int32).view(P, m)
dest = list(dest)
same("dist_scatter_perm", gather.dist_scatter_perm(part(vals), part(dest)),
     gather.dist_scatter_perm(vals, dest))
for k in (0, 1, m - 1, m, m + 5, 3 * m + 2, P * m):
    same(f"shift_{k}", dist_shifted_ranks(part(vals), k),
         dist_shifted_ranks(vals, k))
blocks = [torch.stack([torch.as_tensor(rng.integers(0, 4, m)).int(),
                       torch.as_tensor(rng.integers(0, 50, m)).int(),
                       torch.arange(i * m, (i + 1) * m, dtype=torch.int32)])
          for i in range(P)]
for keys in (3, 2):
    live = [2, 6, 10][:keys]
    same(f"bitonic_{keys}", block_bitonic_sort(part(blocks), keys, live),
         block_bitonic_sort(blocks, keys, live))
srt = block_bitonic_sort(blocks, 3, [2, 6, 10])
cols = [[b[c] for b in srt] for c in range(2)]
got = dist_rerank_multi([part(c) for c in cols])
want = dist_rerank_multi(cols)
same("rerank_dense", got[0], want[0])
same("rerank_max", got[1], want[1])
torch.distributed.destroy_process_group()
with open(out, "w") as f:
    json.dump(checked, f)
"""


@pytest.mark.parametrize("n_proc,dpp", GEOMETRIES)
def test_collectives_across_processes_equal_the_list_form(tmp_path, n_proc,
                                                          dpp):
    outs = [tmp_path / f"rank{r}.json" for r in range(n_proc)]
    cmds = [[sys.executable, "-c", WORKER, str(r), str(n_proc), str(dpp),
             str(tmp_path / "store"), str(o)] for r, o in enumerate(outs)]
    with open(tmp_path / "stdout.txt", "w") as log:
        rc = run_workers(cmds, stdout=log, env=worker_env(), timeout=120)
    assert rc == 0
    checked = [json.loads(o.read_text()) for o in outs]
    assert all(c == checked[0] for c in checked)
    assert len(checked[0]) == 30, checked[0]
