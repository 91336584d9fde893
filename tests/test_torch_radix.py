"""Radix pass and sort of the port against the JAX package's Pallas pass.

The port's plain pass (K2 ``block_digit_sort_reference``, the
``run_offsets`` glue and K3 ``place_runs_reference``, what the wrappers
run for CPU tensors) is held against ``experiments/radix_write.py::
radix_pass_dma`` in interpret mode at rbits 4, shift 8, and the plain
sort against numpy ``lexsort``, exactly (tolerance 0: keys and payloads
are integers). Heavily tied keys are in every case, because a pass that
is not stable goes wrong only on ties. The CUDA cases hold the kernels
against their plain versions on the card and skip where there is none.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_suffix_array_tpu_torch.kernels import launch_counts, pass_counts
from hpc_suffix_array_tpu_torch.kernels.radix import (
    BLOCK, block_digit_sort, block_digit_sort_reference, place_runs,
    place_runs_reference, radix_pass, radix_sort_words,
    radix_sort_words_reference, run_offsets)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def radix_write():
    """experiments/radix_write.py, loaded by path as test_kernels.py
    does (experiments/ is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "radix_write_port_parity", ROOT / "experiments" / "radix_write.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(kind: str, n: int, seed: int) -> np.ndarray:
    """Uniform 20-bit keys, or the TestRadix skew: 95% one digit."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, n)
    if kind == "skewed":
        keys = np.where(rng.random(n) < 0.95, 15 << 8, keys)
    return keys.astype(np.int32)


def _cols(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in arrays]


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_pass_matches_radix_pass_dma(radix_write, kind):
    n = 2 * radix_write.BLOCK
    keys = _keys(kind, n, 11)
    pay = np.arange(n, dtype=np.int32)
    want_k, want_p = radix_write.radix_pass_dma(
        jnp.asarray(keys), jnp.asarray(pay), 8, True)
    got = radix_pass(_cols(keys, pay), 0, 8, 4)
    assert np.array_equal(got[0].numpy(), np.asarray(want_k))
    assert np.array_equal(got[1].numpy(), np.asarray(want_p))


@pytest.mark.parametrize("n", [1, 1000, BLOCK, 3 * BLOCK + 17])
@pytest.mark.parametrize("rbits,shift", [(4, 8), (8, 0), (8, 12), (3, 29)])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_pass_is_stable_digit_partition(n, rbits, shift, kind):
    """K2 -> glue -> K3 equals numpy's stable argsort of the digit, for
    partial last blocks too, and K2's histogram is the per-block count."""
    keys = _keys(kind, n, n + rbits)
    pay = np.arange(n, dtype=np.int32)[::-1].copy()
    digit = (keys.astype(np.int64) >> shift) & ((1 << rbits) - 1)
    cols = _cols(keys, pay)
    staged, hist = block_digit_sort_reference(cols, 0, shift, rbits)
    blocks = np.arange(n) // BLOCK
    want_hist = np.zeros((-(-n // BLOCK), 1 << rbits), np.int64)
    np.add.at(want_hist, (blocks, digit), 1)
    assert np.array_equal(hist.numpy(), want_hist)
    local = np.lexsort((np.arange(n), digit, blocks))
    assert np.array_equal(staged[0].numpy(), keys[local])
    out = place_runs_reference(staged, 0, shift, rbits, *run_offsets(hist))
    order = np.argsort(digit, kind="stable")
    assert np.array_equal(out[0].numpy(), keys[order])
    assert np.array_equal(out[1].numpy(), pay[order])


def test_run_offsets_match_radix_pass_dma_glue():
    """The glue's (block, digit) starts are radix_write.py:371-379's
    digit-major dst and src tables, laid out [block, digit]."""
    rng = np.random.default_rng(3)
    nb, R = 5, 16
    hist = rng.integers(0, 50, (nb, R)).astype(np.int32)
    run_dst, run_src = run_offsets(torch.from_numpy(hist))
    totals = hist.sum(0)
    digit_starts = np.r_[0, np.cumsum(totals)[:-1]]
    dst = digit_starts[None, :] + np.cumsum(hist, 0) - hist
    block_within = np.cumsum(hist, 1) - hist
    assert np.array_equal(run_dst.numpy(), dst)
    assert np.array_equal(run_src.numpy(), block_within)


def _lexsort_words(words, payload, live_bits):
    per_word = ([live_bits] * len(words) if isinstance(live_bits, int)
                else live_bits)
    keys = [w.astype(np.int64) & ((1 << b) - 1)
            for w, b in zip(words, per_word)]
    order = np.lexsort([np.arange(len(payload))] + keys[::-1])
    return [w[order] for w in words], payload[order]


@pytest.mark.parametrize("nw", [1, 2, 3])
@pytest.mark.parametrize("live_bits", [30, 13])
def test_radix_sort_words_reference_matches_lexsort(nw, live_bits):
    """Few distinct keys (heavy ties): the order inside ties must be the
    input order."""
    rng = np.random.default_rng(nw * 100 + live_bits)
    n = 5000
    words = [rng.integers(0, 7, n).astype(np.int32) << (live_bits - 3)
             | rng.integers(0, 2, n).astype(np.int32) for _ in range(nw)]
    pay = rng.permutation(n).astype(np.int32)
    want_w, want_p = _lexsort_words(words, pay, live_bits)
    got_w, got_p = radix_sort_words(_cols(*words), _cols(pay)[0], live_bits)
    for g, w in zip(got_w, want_w):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(got_p.numpy(), want_p)


def _mixed_words(live_bits, n, seed):
    """Words with few distinct values in their live bits (heavy ties)
    and random bits above them, which the sort must carry, not read."""
    rng = np.random.default_rng(seed)
    words = []
    for b in live_bits:
        live = rng.integers(0, 5, n) << max(b - 3, 0) | rng.integers(0, 2, n)
        above = rng.integers(0, 1 << 31, n) << b if b < 32 else 0
        words.append(((live & ((1 << b) - 1)) | above).astype(np.uint32)
                     .view(np.int32))
    return words


@pytest.mark.parametrize("live_bits", [[5, 30, 30], [1, 17], [32, 3, 8],
                                       [22]])
def test_radix_sort_words_per_word_live_bits(live_bits):
    """One live-bit width per word (a refinement round's segment word
    beside two window words), against numpy lexsort on the same bits."""
    n = 5000
    words = _mixed_words(live_bits, n, sum(live_bits))
    pay = np.random.default_rng(1).permutation(n).astype(np.int32)
    want_w, want_p = _lexsort_words(words, pay, live_bits)
    got_w, got_p = radix_sort_words(_cols(*words), _cols(pay)[0], live_bits)
    for g, w in zip(got_w, want_w):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(got_p.numpy(), want_p)


@pytest.mark.parametrize("live_bits", [[30, 30], [0, 30, 30], [33], []])
def test_radix_sort_words_rejects_bad_live_bits(live_bits):
    words = _cols(*[np.zeros(8, np.int32)] * 3)
    with pytest.raises(ValueError):
        radix_sort_words(words, _cols(np.arange(8))[0], live_bits)


def test_radix_sort_words_sorts_live_bits_only():
    """Bits above live_bits are carried, not sorted on: the kernel runs
    passes only over the live bits, and so does the plain version."""
    w = np.array([(1 << 20) | 1, 0, (1 << 20) | 0], np.int32)
    pay = np.arange(3, dtype=np.int32)
    got_w, got_p = radix_sort_words_reference(_cols(w), _cols(pay)[0], 20)
    assert got_p.tolist() == [1, 2, 0]
    assert got_w[0].tolist() == [0, 1 << 20, (1 << 20) | 1]


@pytest.mark.parametrize("change,err", [
    (dict(cols=[]), ValueError),
    (dict(key_col=2), ValueError),
    (dict(rbits=9), ValueError),
    (dict(shift=32), ValueError),
    (dict(cols=[np.zeros(8, np.int64)]), TypeError),
])
def test_block_digit_sort_rejects_bad_arguments(change, err):
    args = dict(cols=[np.zeros(8, np.int32)], key_col=0, shift=0, rbits=8)
    args.update(change)
    cols = [torch.from_numpy(c) for c in args["cols"]]
    with pytest.raises(err):
        block_digit_sort(cols, args["key_col"], args["shift"],
                         args["rbits"])


def test_radix_has_no_fallback_for_other_devices():
    """Only CPU tensors take the plain versions; other devices that are
    not CUDA raise instead of computing somewhere else."""
    cols = [torch.zeros(64, dtype=torch.int32, device="meta")]
    before = launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        block_digit_sort(cols, 0, 0, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        radix_sort_words(cols, cols[0].clone(), 30)
    assert launch_counts() == before


# --- on the card --------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, BLOCK, 5 * BLOCK + 3, 1 << 16])
@pytest.mark.parametrize("rbits,shift", [(4, 8), (8, 0), (8, 24), (6, 3)])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_kernels_match_plain_on_card(n, rbits, shift, kind):
    _need_cuda()
    keys = _keys(kind, n, n + shift)
    cols = [c.cuda() for c in _cols(keys, np.arange(n), keys ^ 0x5A5A)]
    before = launch_counts()["block_digit_sort"]
    staged, hist = block_digit_sort(cols, 0, shift, rbits)
    assert launch_counts()["block_digit_sort"] == before + 1
    want_staged, want_hist = block_digit_sort_reference(cols, 0, shift,
                                                        rbits)
    torch.cuda.synchronize()
    assert torch.equal(hist, want_hist)
    for g, w in zip(staged, want_staged):
        assert torch.equal(g, w)
    offs = run_offsets(hist)
    before = launch_counts()["place_runs"]
    got = place_runs(staged, 0, shift, rbits, *offs)
    assert launch_counts()["place_runs"] == before + 1
    want = place_runs_reference(staged, 0, shift, rbits, *offs)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [1, 2, 3])
@pytest.mark.parametrize("rbits", [4, 8])
def test_radix_sort_words_matches_plain_on_card(nw, rbits):
    _need_cuda()
    rng = np.random.default_rng(nw + rbits)
    n = 300_001
    words = [(rng.integers(0, 5, n) << 25 | rng.integers(0, 3, n)
              ).astype(np.int32) for _ in range(nw)]
    pay = np.arange(n, dtype=np.int32)
    got_w, got_p = radix_sort_words([c.cuda() for c in _cols(*words)],
                                    _cols(pay)[0].cuda(), 30, rbits)
    want_w, want_p = radix_sort_words_reference(
        [c.cuda() for c in _cols(*words)], _cols(pay)[0].cuda(), 30)
    torch.cuda.synchronize()
    assert torch.equal(got_p, want_p)
    for g, w in zip(got_w, want_w):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_radix_sort_words_per_word_live_bits_on_card():
    """A refinement round's shape: (segment, word 0, word 1; idx) at 22,
    30 and 30 live bits, 11 passes (run or skipped) on the onesweep
    kernels, against the plain version."""
    _need_cuda()
    n = 1 << 20
    words = _mixed_words([22, 30, 30], n, 3)
    pay = np.arange(n, dtype=np.int32)
    before = {**launch_counts(), **pass_counts()}
    got_w, got_p = radix_sort_words([c.cuda() for c in _cols(*words)],
                                    _cols(pay)[0].cuda(), [22, 30, 30])
    got = {k: v - before[k]
           for k, v in {**launch_counts(), **pass_counts()}.items()}
    run = got["passes_run"]
    assert run + got["passes_skipped"] == 11
    assert got["onesweep_pass"] == run
    assert got["block_digit_sort"] == 0
    want_w, want_p = radix_sort_words_reference(
        [c.cuda() for c in _cols(*words)], _cols(pay)[0].cuda(),
        [22, 30, 30])
    torch.cuda.synchronize()
    assert torch.equal(got_p, want_p)
    for g, w in zip(got_w, want_w):
        assert torch.equal(g, w)
