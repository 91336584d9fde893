"""Pack kernel of the PyTorch port against the JAX package's.

The port's plain folds (``pack_ranks_reference`` and
``pack_words_reference``, what ``pack_ranks`` and ``pack_words`` run for
a CPU tensor) are held against the Pallas kernel in interpret mode and
against the JAX package's XLA folds (``pack_ranks_kernel``,
``core/bigsort.py::_dev_pack_word``), exactly (tolerance 0: the codes
are integers). Every table holds codes below 2^bits, the kernel's
precondition. The CUDA cases compare the hand-written kernel with the
plain folds on the card and skip where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_suffix_array_tpu.core.bigsort import _dev_pack_word
from hpc_suffix_array_tpu.core.suffix_array import (
    pack_ranks_kernel as jax_pack_ranks_kernel)
from hpc_suffix_array_tpu.kernels.pack import pack_ranks_pallas
from hpc_suffix_array_tpu_torch.core import refine as trf
from hpc_suffix_array_tpu_torch.kernels import launch_counts
from hpc_suffix_array_tpu_torch.kernels.pack import (
    pack_ranks, pack_ranks_reference, pack_words, pack_words_reference)

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
    before = launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        pack_ranks(text, remap, 6, 5, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        pack_words(text, remap, 6, 5, 128, 2)
    assert launch_counts() == before


def _word_inputs(seed, n, bits, minpad):
    """Text and a carried-keys table: codes 1..2^bits-1, or under minpad
    0..2^bits-2 (``key_table``'s ``max(remap - 1, 0)``)."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 256, n).astype(np.uint8)
    table = rng.integers(1, 1 << bits, 256).astype(np.int32)
    return text, (np.maximum(table - 1, 0) if minpad else table)


def _torch_words(text, table, bits, spw, n_real, n_words, **kw):
    return [w.numpy() for w in pack_words(
        torch.from_numpy(text), torch.from_numpy(table), bits, spw, n_real,
        n_words, **kw)]


@pytest.mark.parametrize("bits,spw", WORD_CASES)
@pytest.mark.parametrize("n_words", [1, 2, 3])
@pytest.mark.parametrize("minpad", [False, True])
def test_pack_words_matches_jax_dev_pack_word(bits, spw, n_words, minpad):
    """Word w of ``pack_words`` equals JAX ``_dev_pack_word`` at element
    offset w*spw over the codes, 0 past n_real."""
    n = 1000
    text, table = _word_inputs(bits + 7 * n_words, n, bits, minpad)
    for n_real in (n, n - 11):
        codes = np.zeros(n + 3 * spw, np.int32)
        codes[:n_real] = table[text[:n_real]]
        got = _torch_words(text, table, bits, spw, n_real, n_words)
        assert len(got) == n_words
        for w in range(n_words):
            want = np.asarray(_dev_pack_word(jnp.asarray(codes), w * spw,
                                             spw, bits, n))
            assert got[w].dtype == np.int32
            assert np.array_equal(got[w], want)


@pytest.mark.parametrize("bits,spw", WORD_CASES)
@pytest.mark.parametrize("offset,n_out", [(0, 1000), (0, 300), (37, 500),
                                          (990, 50), (1200, 8)])
def test_pack_words_matches_pack_ranks_reference(bits, spw, offset, n_out):
    """Rows [0, n_out) of the text from ``offset``: word w equals
    ``pack_ranks_reference`` at offset + w*spw, also where n_out rows run
    past the text's end or n_out < n_real."""
    n = 1000
    text, table = _word_inputs(offset + bits, n, bits, False)
    t, tab = torch.from_numpy(text), torch.from_numpy(table)
    for n_real in (n, 700):
        got = pack_words(t, tab, bits, spw, n_real, 3, offset=offset,
                         n_out=n_out)
        for w in range(3):
            full = pack_ranks_reference(
                torch.cat([t, t.new_zeros(n_out + offset)]), tab, bits,
                spw, n_real, offset + w * spw)
            assert torch.equal(got[w], full[:n_out])


@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_pack_words_into_column_table(n_words):
    """``out`` as the columns of a row-major (rows, n_words) table: the
    same words, rows past n_out untouched."""
    n, bits, spw = 777, 2, 15
    text, table = _word_inputs(n_words, n, bits, True)
    t, tab = torch.from_numpy(text), torch.from_numpy(table)
    grid = torch.full((n + 1, n_words), -5, dtype=torch.int32)
    cols = [grid[:n, w] for w in range(n_words)]
    back = pack_words(t, tab, bits, spw, n, n_words, out=cols)
    want = pack_words(t, tab, bits, spw, n, n_words)
    for w in range(n_words):
        assert back[w].data_ptr() == cols[w].data_ptr()
        assert torch.equal(grid[:n, w], want[w])
    assert (grid[n] == -5).all()


@pytest.mark.parametrize("change,err", [
    (dict(n_words=0), ValueError),
    (dict(n_words=4), ValueError),
    (dict(n_out=-1), ValueError),
    (dict(out="short"), ValueError),
    (dict(out="int64"), TypeError),
    (dict(out="rows"), TypeError),
    (dict(out="strides"), ValueError),
])
def test_pack_words_rejects_bad_arguments(change, err):
    args = dict(n_words=2, n_out=None, out=None)
    args.update(change)
    rows = 64 if args["n_out"] is None else args["n_out"]
    kind = args["out"]
    if kind == "short":
        args["out"] = [torch.zeros(rows, dtype=torch.int32)]
    elif kind == "int64":
        args["out"] = [torch.zeros(rows, dtype=torch.int64)] * 2
    elif kind == "rows":
        args["out"] = [torch.zeros(rows + 1, dtype=torch.int32)] * 2
    elif kind == "strides":
        grid = torch.zeros((rows, 2), dtype=torch.int32)
        args["out"] = [grid[:, 0], torch.zeros(rows, dtype=torch.int32)]
    with pytest.raises(err):
        pack_words(torch.zeros(64, dtype=torch.uint8),
                   torch.zeros(256, dtype=torch.int32), 6, 5, 64,
                   args["n_words"], n_out=args["n_out"], out=args["out"])


@pytest.mark.parametrize("sigma", [4, 5, 63, 256])
def test_pair_table_matches_two_call_construction(sigma):
    """pk2 from one two-word launch into its columns equals the earlier
    construction: zeros, then ``pack_ranks`` at offsets 0 and spw."""
    rng = np.random.default_rng(sigma + 1)
    n = 5000
    remap = np.zeros(256, np.int32)
    remap[:sigma] = np.arange(1, sigma + 1)
    text = torch.from_numpy(rng.integers(0, sigma, n).astype(np.uint8))
    bits, spw = trf.refine_packing(sigma)
    table = torch.from_numpy(remap)
    want = torch.zeros((n + 1, 2), dtype=torch.int32)
    for col in range(2):
        want[:n, col] = pack_ranks(text, table, bits, spw, n,
                                   offset=col * spw)
    assert torch.equal(trf.pair_table(text, remap), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits,h0", CASES + [(1000, 6, 5)])
def test_pack_kernel_matches_plain_on_card(n, bits, h0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    text, remap = _inputs(n + bits, n, bits)
    t = torch.from_numpy(text).cuda()
    r = torch.from_numpy(remap).cuda()
    for n_real in (n, n // 3):
        before = launch_counts()["pack_ranks"]
        got = pack_ranks(t, r, bits, h0, n_real)
        assert launch_counts()["pack_ranks"] == before + 1
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


def _on_card(text, table):
    return (torch.from_numpy(text).cuda(), torch.from_numpy(table).cuda())


@pytest.mark.cuda
@pytest.mark.parametrize("bits,spw", WORD_CASES)
@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_pack_words_offsets_on_card(bits, spw, n_words):
    """Word offsets 1-7 and 0, tails that are not a multiple of the
    4096-row tile, n_out below and above n_real."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    n = 4096 * 3 + 5
    text, table = _word_inputs(bits * n_words, n, bits, False)
    t, tab = _on_card(text, table)
    for offset in range(8):
        for n_real, n_out in ((n, n), (n - 3, n - offset), (n, 4097),
                              (n - 9, 100)):
            before = launch_counts()["pack_words"]
            got = pack_words(t, tab, bits, spw, n_real, n_words,
                             offset=offset, n_out=n_out)
            assert launch_counts()["pack_words"] == before + 1
            want = pack_words_reference(t, tab, bits, spw, n_real, n_words,
                                        offset=offset, n_out=n_out)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("start", [1, 3, 5, 15, 16])
@pytest.mark.parametrize("n_words", [1, 2, 3])
def test_pack_words_text_views_on_card(start, n_words):
    """Text views that start at odd addresses (``t[1:]``, ``t[3:]``, ...)
    read through the aligned 16-byte path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    n = 4096 * 5 + 77
    text, table = _word_inputs(start, n, 6, False)
    t, tab = _on_card(text, table)
    view = t[start:]
    assert view.is_contiguous()
    m = view.shape[0]
    for n_real in (m, m - 40):
        got = pack_words(view, tab, 6, 5, n_real, n_words)
        want = pack_words_reference(view, tab, 6, 5, n_real, n_words)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_words,width", [(2, 2), (2, 3), (3, 3), (1, 2),
                                           (2, 4)])
def test_pack_words_column_table_on_card(n_words, width):
    """Strided column output: the (rows, 2) pair layout, and tables of
    other widths (4-byte stores)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    n = 4096 * 4 + 123
    text, table = _word_inputs(width, n, 2, True)
    t, tab = _on_card(text, table)
    grid = torch.full((n + 1, width), -5, dtype=torch.int32, device="cuda")
    cols = [grid[:n, w] for w in range(n_words)]
    pack_words(t, tab, 2, 15, n, n_words, out=cols)
    want = pack_words_reference(t, tab, 2, 15, n, n_words)
    torch.cuda.synchronize()
    for w in range(n_words):
        assert torch.equal(grid[:n, w], want[w])
    assert (grid[n] == -5).all() and (grid[:, n_words:] == -5).all()
    pk2 = trf.pair_table(t, np.arange(256, dtype=np.int32) % 4 + 1)
    assert torch.equal(pk2.cpu(), trf.pair_table(
        t.cpu(), np.arange(256, dtype=np.int32) % 4 + 1))
