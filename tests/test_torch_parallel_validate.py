"""The port's sharded validator against the JAX package's: it accepts
exactly the true suffix array. Mirrors ``tests/test_parallel_validate.py``
on 8 shards (the port's on the one CPU)."""

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu.parallel as jpar
import hpc_suffix_array_tpu_torch.parallel as tpar
from hpc_suffix_array_tpu_torch.parallel import mesh as tmesh

from tests.conftest import CANONICAL


@pytest.fixture(scope="module")
def meshes():
    return jpar.make_mesh(8), tpar.make_mesh(8, devices=["cpu"])


def _verdicts(text, sa, meshes) -> bool:
    """The port's verdict, held equal to the JAX package's."""
    jmesh, tm = meshes
    reads = tmesh.read_scalar.reads
    got = tpar.is_valid_suffix_array_sharded(text, sa, tm)
    assert tmesh.read_scalar.reads - reads == 1      # one host read
    assert got is jpar.is_valid_suffix_array_sharded(
        text, np.asarray(sa), jmesh)
    return got


@pytest.mark.parametrize("name", sorted(CANONICAL))
def test_accepts_true_sa(meshes, name):
    text = CANONICAL[name]
    sa = tpar.build_suffix_array_sharded(text, meshes[1])
    assert _verdicts(text, sa.numpy(), meshes)


@pytest.mark.parametrize("alpha", [2, 256])
def test_random_accept_and_reject(meshes, alpha):
    rng = np.random.default_rng(alpha)
    text = rng.integers(0, alpha, 3000, dtype=np.uint8).tobytes()
    sa = tpar.build_suffix_array_sharded(text, meshes[1]).numpy()
    assert _verdicts(text, sa, meshes)

    bad = sa.copy()
    bad[10], bad[2000] = bad[2000], bad[10]        # order violation
    assert not _verdicts(text, bad, meshes)

    dup = sa.copy()
    dup[5] = dup[6]                                # not a permutation
    assert not _verdicts(text, dup, meshes)

    shifted = (sa + 1) % len(sa)                   # permutation, wrong order
    assert not _verdicts(text, shifted, meshes)


@pytest.mark.parametrize("entry", [-1, 3000, 1 << 20])
def test_rejects_out_of_range_entries(meshes, entry):
    text = np.random.default_rng(0).integers(0, 4, 3000,
                                             dtype=np.uint8).tobytes()
    sa = tpar.build_suffix_array_sharded(text, meshes[1]).numpy()
    sa[100] = entry
    assert not _verdicts(text, sa, meshes)


def test_zero_byte_text(meshes):
    text = b"xy\x00\x00" * 200
    sa = tpar.build_suffix_array_sharded(text, meshes[1])
    assert _verdicts(text, sa.numpy(), meshes)


def test_wrong_length_and_empty_and_input_forms(meshes):
    tm = meshes[1]
    text = np.frombuffer(b"mississippi", np.uint8)
    sa = torch.tensor([10, 7, 4, 1, 0, 9, 8, 6, 3, 5, 2], dtype=torch.int32)
    assert tpar.is_valid_suffix_array_sharded(text, sa, tm)
    assert tpar.is_valid_suffix_array_sharded(torch.from_numpy(text.copy()),
                                              sa.numpy(), tm)
    assert not tpar.is_valid_suffix_array_sharded(text, sa[:-1], tm)
    assert tpar.is_valid_suffix_array_sharded(b"", [], tm)
