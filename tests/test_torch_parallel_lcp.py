"""The port's distributed PLCP against the JAX package's and Kasai.

Mirrors ``tests/test_parallel_lcp.py``: byte equality with Kasai on every
input class, including texts of 0x00 bytes (which stress the pad
guards), on meshes of 2 and 8 shards; the JAX side runs on the virtual
CPU devices, the port on the one CPU. Both builders take the real SA
from the port's sharded builder.
"""

import functools

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu.parallel as jpar
import hpc_suffix_array_tpu_torch.parallel as tpar
from hpc_suffix_array_tpu.parallel.lcp import (
    build_lcp_array_sharded as jax_lcp_sharded)
from hpc_suffix_array_tpu_torch.core.oracle import lcp_oracle
from hpc_suffix_array_tpu_torch.parallel import lcp as tlcp
from hpc_suffix_array_tpu_torch.parallel import mesh as tmesh

from tests.conftest import CANONICAL

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)


@pytest.fixture(scope="module", params=[2, 8])
def p(request):
    return request.param


@functools.cache
def _jax_lcp(text: bytes, p: int, sa: bytes) -> np.ndarray:
    sa = np.frombuffer(sa, np.int32)
    return np.asarray(jax_lcp_sharded(text, sa, jpar.make_mesh(p)))


def _check(text: bytes, p: int):
    mesh = tpar.make_mesh(p, devices=["cpu"])
    sa = tpar.build_suffix_array_sharded(text, mesh)
    info: dict = {}
    reads = tmesh.read_scalar.reads
    lcp = tpar.build_lcp_array_sharded(text, sa, mesh, info=info)
    assert lcp.dtype == torch.int32 and lcp.device.type == "cpu"
    want = lcp_oracle(text, sa.numpy())
    assert np.array_equal(lcp.numpy(), want)
    assert np.array_equal(lcp.numpy(),
                          _jax_lcp(text, p, sa.numpy().tobytes()))
    # One host read per round: the replicated unresolved count.
    assert tmesh.read_scalar.reads - reads == info["plcp_rounds"] >= 1


@pytest.mark.parametrize("name", sorted(CANONICAL))
def test_canonical(p, name):
    _check(CANONICAL[name], p)


@pytest.mark.parametrize("n,alpha", [(1, 256), (100, 4), (1023, 2),
                                     (5000, 256), (4000, 4)])
def test_random(p, n, alpha):
    rng = np.random.default_rng(n)
    _check(rng.integers(0, alpha, n, dtype=np.uint8).tobytes(), p)


def test_zero_bytes(p):
    """0x00 text bytes must not be confused with the pad."""
    _check(b"\x00" * 700, p)
    _check(b"xy\x00\x00\x00" * 100 + b"\x00\x00\x00", p)


def test_matches_single_device(p):
    from hpc_suffix_array_tpu_torch.core.lcp import build_lcp_array
    from hpc_suffix_array_tpu_torch.core.suffix_array import (
        build_suffix_array)

    text = np.random.default_rng(3).integers(0, 30, 4000,
                                             dtype=np.uint8).tobytes()
    sa1 = build_suffix_array(text, device="cpu")
    sa2 = tpar.build_suffix_array_sharded(text, tpar.make_mesh(
        p, devices=["cpu"]))
    assert torch.equal(sa1, sa2)
    assert torch.equal(
        build_lcp_array(text, sa1, device="cpu"),
        tpar.build_lcp_array_sharded(text, sa2, tpar.make_mesh(
            p, devices=["cpu"])))


def test_long_repeats_take_several_rounds(p):
    """Periodic alnum: long LCPs need propagation and pointer jumping
    across shards."""
    rng = np.random.default_rng(11)
    text = np.tile(ALNUM[rng.integers(0, 62, 37)], 100).tobytes()
    _check(text, p)


def test_input_forms_and_empty_text():
    mesh = tpar.make_mesh(4, devices=["cpu"])
    arr = np.frombuffer(b"abracadabra" * 30, np.uint8)
    sa = tpar.build_suffix_array_sharded(arr, mesh)
    want = lcp_oracle(arr, sa.numpy())
    for text, s in ((arr, sa.numpy()), (torch.from_numpy(arr.copy()), sa),
                    (arr.tobytes(), sa)):
        assert np.array_equal(
            tpar.build_lcp_array_sharded(text, s, mesh).numpy(), want)
    assert tpar.build_lcp_array_sharded(b"", [], mesh).shape == (0,)


@pytest.mark.parametrize("m,want", [(128, 1), (1 << 16, 1), (1 << 17, 2),
                                    (1 << 21, 32), (3 << 20, 64),
                                    (1 << 26, 1024)])
def test_chunk_count_rule(m, want):
    """A power of two dividing m, sized so a chunk's text-window
    requests stay about 2^20 (the JAX package's rule)."""
    assert tlcp.chunk_count(m) == want
    assert m % want == 0
