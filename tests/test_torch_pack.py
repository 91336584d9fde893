"""Pack kernel of the PyTorch port against the JAX package's.

The port's plain fold (``pack_ranks_reference``, what ``pack_ranks``
runs for a CPU tensor) is held against the Pallas kernel in interpret
mode and against the JAX package's XLA fold, exactly (tolerance 0: the
codes are integers). The CUDA case compares the hand-written kernel
with the plain fold on the card and skips where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_suffix_array_tpu.core.suffix_array import (
    pack_ranks_kernel as jax_pack_ranks_kernel)
from hpc_suffix_array_tpu.kernels.pack import pack_ranks_pallas
from hpc_suffix_array_tpu_torch.kernels.pack import (
    pack_ranks, pack_ranks_reference)

# (n, bits, h0) of the JAX package's own kernel tests.
CASES = [(128, 6, 5), (128 * 8, 3, 10), (128 * 9, 9, 3),
         (128 * 513, 6, 5), (1 << 17, 1, 30)]


def _inputs(seed, n, bits):
    """Random text and a remap whose codes fit ``bits`` (<= 256)."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 256, n).astype(np.uint8)
    remap = rng.integers(0, min(1 << bits, 257), 256).astype(np.int32)
    return text, remap


def _port(text, remap, bits, h0, n_real, offset=0):
    return pack_ranks(torch.from_numpy(text), torch.from_numpy(remap),
                      bits, h0, n_real, offset).numpy()


@pytest.mark.parametrize("n,bits,h0", CASES)
def test_pack_matches_pallas(n, bits, h0):
    text, remap = _inputs(n + bits, n, bits)
    want = np.asarray(pack_ranks_pallas(jnp.asarray(remap[text]), bits, h0,
                                        True))
    assert np.array_equal(_port(text, remap, bits, h0, n), want)


def test_pack_zero_tail():
    """Trailing zero codes (the pad region) fold in as 0."""
    rng = np.random.default_rng(7)
    text = np.zeros(1024, np.uint8)
    text[:100] = rng.integers(1, 4, 100)
    remap = (np.arange(256) % 4).astype(np.int32)
    want = np.asarray(pack_ranks_pallas(jnp.asarray(remap[text]), 2, 15,
                                        True))
    assert np.array_equal(_port(text, remap, 2, 15, 1024), want)


@pytest.mark.parametrize("n,n_real,bits,h0", [
    (1024, 1024, 6, 5),      # full, multiple of 128
    (1024, 600, 3, 10),      # masked tail
    (1000, 1000, 9, 3),      # n not a multiple of 128
    (1000, 1, 2, 15),        # one real position
])
def test_pack_matches_jax_fold(n, n_real, bits, h0):
    text, remap = _inputs(n_real, n, bits)
    want = np.asarray(jax_pack_ranks_kernel(
        jnp.asarray(text), jnp.asarray(remap), bits, h0, n_real))
    assert np.array_equal(_port(text, remap, bits, h0, n_real), want)


# Word-mode cases: (bits, spw) of the carried-keys packings, word 0-2.
WORD_CASES = [(6, 5), (2, 15), (1, 30), (8, 3)]


@pytest.mark.parametrize("bits,spw", WORD_CASES)
@pytest.mark.parametrize("word", [0, 1, 2])
def test_pack_word_offset_matches_shifted_fold(bits, spw, word):
    """out[i] folds the codes from i + word*spw; past n_real reads 0."""
    n = 1000
    text, remap = _inputs(bits * 10 + word, n, bits)
    codes = np.concatenate([remap[text].astype(np.int64),
                            np.zeros(3 * spw, np.int64)])
    for n_real in (n, n - 7):
        codes[n_real:] = 0
        off = word * spw
        want = np.zeros(n, np.int64)
        for j in range(spw):
            want = (want << bits) | codes[off + j:off + j + n]
        got = _port(text, remap, bits, spw, n_real, offset=off)
        assert np.array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("change,err", [
    (dict(bits=10, h0=3), ValueError),
    (dict(bits=6, h0=6), ValueError),          # 36 bits > 30
    (dict(n_real=2000), ValueError),
    (dict(text=np.zeros(8, np.int32)), TypeError),
    (dict(remap=np.zeros(255, np.int32)), TypeError),
    (dict(offset=-1), ValueError),
])
def test_pack_rejects_bad_arguments(change, err):
    args = dict(text=np.zeros(1024, np.uint8),
                remap=np.zeros(256, np.int32), bits=6, h0=5, n_real=1024,
                offset=0)
    args.update(change)
    with pytest.raises(err):
        pack_ranks(torch.from_numpy(args["text"]),
                   torch.from_numpy(args["remap"]), args["bits"],
                   args["h0"], args["n_real"], args["offset"])


def test_pack_has_no_fallback_for_other_devices():
    """Only a CPU tensor takes the plain fold; anything else that is not
    CUDA raises instead of computing somewhere else."""
    text = torch.zeros(128, dtype=torch.uint8, device="meta")
    remap = torch.zeros(256, dtype=torch.int32, device="meta")
    before = pack_ranks.launches
    with pytest.raises(ValueError, match="unsupported device"):
        pack_ranks(text, remap, 6, 5, 128)
    assert pack_ranks.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits,h0", CASES + [(1000, 6, 5)])
def test_pack_kernel_matches_plain_on_card(n, bits, h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    text, remap = _inputs(n + bits, n, bits)
    t = torch.from_numpy(text).cuda()
    r = torch.from_numpy(remap).cuda()
    for n_real in (n, n // 3):
        before = pack_ranks.launches
        got = pack_ranks(t, r, bits, h0, n_real)
        assert pack_ranks.launches == before + 1
        want = pack_ranks_reference(t, r, bits, h0, n_real)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,spw", WORD_CASES)
@pytest.mark.parametrize("n", [1000, 4096 * 3 + 5])
def test_pack_word_offset_on_card(bits, spw, n):
    """Word offsets move the tile's read window; word 2 of a 1-bit
    alphabet reads 89 positions past i, beyond the 32-position halo."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    text, remap = _inputs(n + bits, n, bits)
    t = torch.from_numpy(text).cuda()
    r = torch.from_numpy(remap).cuda()
    for word in (0, 1, 2):
        for n_real in (n, n - 3):
            got = pack_ranks(t, r, bits, spw, n_real, word * spw)
            want = pack_ranks_reference(t, r, bits, spw, n_real, word * spw)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
