"""The onesweep radix sort of the port against the JAX package's radix pass.

The plain versions (``digit_histograms_reference``,
``onesweep_pass_reference``, the pass plan and the pass loop
``sort_passes``, which is what ``radix_sort_words`` runs on the card)
are held against ``experiments/radix_write.py``'s Pallas
``block_digit_sort`` and ``radix_pass_dma`` in interpret mode at rbits 4,
against the port's K2 -> run_offsets -> K3 chain, and against numpy
``bincount`` and ``lexsort``, exactly (tolerance 0: keys and payloads
are integers). The CUDA cases hold the kernels against their plain
versions on the card and skip where there is none.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hpc_suffix_array_tpu_torch.kernels import launch_counts, pass_counts
from hpc_suffix_array_tpu_torch.kernels.radix import (
    BLOCK, MAX_COLS, MAX_RADIX, TILE, TILES, LookBack,
    block_digit_sort_reference, digit_histograms, digit_histograms_reference,
    n_tiles, onesweep_pass, onesweep_pass_reference, pass_plan,
    place_runs_reference, plan_passes, radix_sort_words,
    radix_sort_words_reference, run_offsets, sort_passes, tile_elems)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def radix_write():
    """experiments/radix_write.py, loaded by path (not a package)."""
    spec = importlib.util.spec_from_file_location(
        "radix_write_onesweep_parity",
        ROOT / "experiments" / "radix_write.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _keys(kind: str, n: int, seed: int) -> np.ndarray:
    """int32 keys: uniform over all 32 bits (negative ones read as
    uint32), the TestRadix skew (95% one key), all equal (every tile on
    one digit: the longest look-back chains) or descending."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(0, 1 << 32, n).astype(np.uint32).view(np.int32)
    if kind == "skewed":
        keys = rng.integers(0, 1 << 20, n)
        return np.where(rng.random(n) < 0.95, 15 << 8, keys).astype(np.int32)
    if kind == "equal":
        return np.full(n, 0x5A5A5A5A, np.int32)
    return ((n - np.arange(n)) * (((1 << 31) - 1) // n)).astype(np.int32)


def _cols(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.int32))
            for a in arrays]


def _digit(keys: np.ndarray, shift: int, bits: int) -> np.ndarray:
    return (keys.view(np.uint32).astype(np.int64) >> shift) & ((1 << bits)
                                                              - 1)


def _plain_hist(words, per_word, rbits):
    return digit_histograms_reference(words, per_word, rbits)


def _plain_pass(src, key_col, shift, bits, digit_starts, dst):
    onesweep_pass_reference(src, key_col, shift, bits, out=dst)


def _pass_args(cols, key_col, shift, rbits):
    """(digit_starts, LookBack) of one onesweep_pass outside a sort: the
    exclusive scan of the plain digit counts, and one pass's scratch."""
    key = cols[key_col]
    digit = ((key.long() & 0xFFFFFFFF) >> shift) & ((1 << rbits) - 1)
    hist = torch.bincount(digit, minlength=1 << rbits)
    return ((torch.cumsum(hist, 0) - hist).to(torch.int32),
            LookBack(key.shape[0], 1, key.device))


# --- the plain pass ------------------------------------------------------

@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_onesweep_reference_matches_radix_pass_dma(radix_write, kind):
    n = 2 * radix_write.BLOCK
    keys = _keys(kind, n, 11) & ((1 << 20) - 1)
    pay = np.arange(n, dtype=np.int32)
    want_k, want_p = radix_write.radix_pass_dma(
        jnp.asarray(keys), jnp.asarray(pay), 8, True)
    got = onesweep_pass_reference(_cols(keys, pay), 0, 8, 4)
    assert np.array_equal(got[0].numpy(), np.asarray(want_k))
    assert np.array_equal(got[1].numpy(), np.asarray(want_p))


@pytest.mark.parametrize("n", [1, 1000, BLOCK, 3 * BLOCK + 17])
@pytest.mark.parametrize("rbits,shift", [(4, 8), (8, 0), (8, 24), (3, 29)])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "equal",
                                  "descending"])
def test_onesweep_reference_matches_k2_k3_chain(n, rbits, shift, kind):
    """One onesweep pass equals the split chain of the same pass: K2's
    block sort, the run_offsets glue and K3's run placement."""
    keys = _keys(kind, n, n + rbits)
    cols = _cols(keys, np.arange(n)[::-1], keys ^ 0x1234)
    staged, hist = block_digit_sort_reference(cols, 0, shift, rbits)
    want = place_runs_reference(staged, 0, shift, rbits, *run_offsets(hist))
    got = onesweep_pass_reference(cols, 0, shift, rbits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    order = np.argsort(_digit(keys, shift, rbits), kind="stable")
    assert np.array_equal(got[1].numpy(), np.arange(n)[::-1][order])


def test_onesweep_reference_writes_out():
    keys = _keys("skewed", 3000, 5)
    cols = _cols(keys, np.arange(3000))
    out = [torch.empty_like(c) for c in cols]
    got = onesweep_pass_reference(cols, 0, 8, 8, out=out)
    assert got is out
    for g, w in zip(out, onesweep_pass_reference(cols, 0, 8, 8)):
        assert torch.equal(g, w)


# --- histograms and the plan ---------------------------------------------

@pytest.mark.parametrize("shift", [0, 8])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_digit_histograms_reference_matches_block_digit_sort(
        radix_write, kind, shift):
    """The histogram row of a pass is the JAX K2's per-block histogram,
    summed over blocks (interpret mode, 4-bit digits)."""
    n = 2 * radix_write.BLOCK
    keys = _keys(kind, n, 21) & ((1 << 20) - 1)
    _, _, hist = radix_write.block_digit_sort(
        jnp.asarray(keys), jnp.asarray(np.arange(n, dtype=np.int32)),
        shift, True)
    rows = digit_histograms_reference(_cols(keys), 12, 4)
    plan = pass_plan([12], 4)
    row = plan.index((0, shift, 4))
    assert np.array_equal(rows[row].numpy(),
                          np.asarray(hist).sum(axis=0))


@pytest.mark.parametrize("live_bits", [[30], [5, 17], [28, 30, 30],
                                       [32, 3, 8], [1, 32]])
@pytest.mark.parametrize("rbits", [4, 8, 3])
def test_digit_histograms_reference_matches_bincount(live_bits, rbits):
    n = 5000
    rng = np.random.default_rng(sum(live_bits) + rbits)
    words = [rng.integers(0, 1 << 32, n).astype(np.uint32).view(np.int32)
             for _ in live_bits]
    hist = digit_histograms_reference(_cols(*words), live_bits, rbits)
    plan = pass_plan(live_bits, rbits)
    assert tuple(hist.shape) == (len(plan), 1 << rbits)
    assert hist.dtype == torch.int32
    for row, (w, shift, bits) in zip(hist.numpy(), plan):
        want = np.bincount(_digit(words[w], shift, bits),
                           minlength=1 << rbits)
        assert np.array_equal(row, want)


def test_pass_plan_order_and_widths():
    """Least significant word first, low digit first; a word's last
    digit takes only its remaining live bits."""
    assert pass_plan([28, 30, 5], 8) == [
        (2, 0, 5),
        (1, 0, 8), (1, 8, 8), (1, 16, 8), (1, 24, 6),
        (0, 0, 8), (0, 8, 8), (0, 16, 8), (0, 24, 4)]
    assert pass_plan([32], 8) == [(0, s, 8) for s in (0, 8, 16, 24)]
    assert pass_plan([3], 4) == [(0, 0, 3)]


def test_lookback_epochs_share_one_zeroing():
    """Each pass of a sort gets a larger epoch and its own zeroed tile
    counter on one zeroed status array; a pass past the plan raises."""
    lb = LookBack(3 * TILE + 1, 3, "cpu")
    got = [lb.next_pass() for _ in range(3)]
    assert [e for _, _, e in got] == [1, 2, 3]
    status = got[0][0]
    assert all(s is status for s, _, _ in got)
    assert status.dtype == torch.int64 and status.shape[0] == 4 * MAX_RADIX
    assert not status.any() and not any(c.item() for _, c, _ in got)
    with pytest.raises(RuntimeError):
        lb.next_pass()


def test_tile_elems_by_column_count():
    """A tile per column count (1-4), a whole number of warps' worth and
    never smaller than TILE, the tile LookBack is sized by."""
    assert len(TILES) == MAX_COLS
    for c in range(1, MAX_COLS + 1):
        tile = tile_elems(c)
        assert tile == TILES[c - 1] and tile >= TILE and tile % 32 == 0
    assert TILE <= min(TILES)
    for c in (0, MAX_COLS + 1):
        with pytest.raises(ValueError):
            tile_elems(c)


@pytest.mark.parametrize("n", [1, TILE - 1, TILE, TILE + 1, 5 * TILE + 3,
                               (1 << 28) + 1])
def test_lookback_status_fits_every_tile_and_does_not_grow(n):
    """The status holds a word per (tile, digit) of 4,096-element tiles,
    whatever the columns: as many as any pass's tiles need, and no more
    than a 4,096-element tile gave."""
    lb = LookBack(n, 1, "meta")
    status, _, _ = lb.next_pass()
    assert status.shape[0] == -(-n // 4096) * MAX_RADIX
    assert status.shape[0] == n_tiles(n) * MAX_RADIX
    for c in range(1, MAX_COLS + 1):
        assert n_tiles(n, tile_elems(c)) * MAX_RADIX <= status.shape[0]


def test_plan_passes_counts_executed_and_skipped():
    hist = torch.tensor([[0, 7, 0, 0],      # one digit: skipped
                         [3, 0, 4, 0],
                         [0, 0, 0, 0],      # no elements: skipped
                         [1, 1, 1, 4]], dtype=torch.int32)
    starts, run = plan_passes(hist)
    assert run == [False, True, False, True]
    assert starts.dtype == torch.int32
    assert starts.tolist() == [[0, 0, 7, 7], [0, 3, 3, 7], [0, 0, 0, 0],
                               [0, 1, 2, 3]]


# --- the pass loop, driven by the plain versions -------------------------

def _lexsort_words(words, payload, per_word):
    keys = [w.view(np.uint32).astype(np.int64) & ((1 << b) - 1)
            for w, b in zip(words, per_word)]
    order = np.lexsort([np.arange(len(payload))] + keys[::-1])
    return [w[order] for w in words], payload[order]


def _drive_loop(words, per_word, rbits=8):
    """sort_passes on the plain versions; checks it against the plain
    sort and numpy lexsort, and that the inputs hold the result."""
    n = len(words[0])
    pay = np.random.default_rng(n).permutation(n).astype(np.int32)
    cols = _cols(*words, pay)
    inputs = list(cols)
    executed, skipped = sort_passes(cols, per_word, rbits, _plain_hist,
                                    _plain_pass)
    assert all(c is i for c, i in zip(cols, inputs))
    want_w, want_p = radix_sort_words_reference(_cols(*words),
                                                _cols(pay)[0], per_word)
    lex_w, lex_p = _lexsort_words(words, pay, per_word)
    for c, w, lw in zip(cols, want_w, lex_w):
        assert torch.equal(c, w)
        assert np.array_equal(c.numpy(), lw)
    assert torch.equal(cols[-1], want_p)
    assert np.array_equal(cols[-1].numpy(), lex_p)
    assert executed + skipped == len(pass_plan(per_word, rbits))
    return executed, skipped


def test_loop_skips_constant_digits():
    """A word whose live bits are all equal runs no pass; a word that
    varies only in its low byte runs one."""
    n = 6000
    rng = np.random.default_rng(7)
    const = np.full(n, 0x2A2A2A2A, np.int32)
    low = (rng.integers(0, 256, n) | (0x15 << 24)).astype(np.int32)
    assert _drive_loop([const, low], [30, 30]) == (1, 7)


def test_loop_odd_executed_passes_copy_back():
    """Three executed passes: the last lands in staging and is copied
    back, so the sorted columns are in the input buffers."""
    n = 7000
    rng = np.random.default_rng(8)
    word = (rng.integers(0, 1 << 24, n) | (0x3 << 24)).astype(np.int32)
    executed, skipped = _drive_loop([word], [30])
    assert (executed, skipped) == (3, 1)


def test_loop_all_passes_skipped():
    n = 100
    words = [np.full(n, 9, np.int32), np.full(n, -1, np.int32)]
    assert _drive_loop(words, [30, 17]) == (0, 7)


@pytest.mark.parametrize("rows", [4097, 20000])
def test_loop_refinement_shape(rows):
    """A refinement round's (segment, word 0, word 1; idx) sort: a
    non-decreasing segment word on ceil(log2 rows) bits and two heavily
    tied 30-bit window words."""
    rng = np.random.default_rng(rows)
    head = rng.random(rows) < 0.3
    head[0] = True
    seg = (np.cumsum(head) - 1).astype(np.int32)
    words = [seg] + [(rng.integers(0, 40, rows) << 24
                      | rng.integers(0, 3, rows)).astype(np.int32)
                     for _ in range(2)]
    seg_bits = max(1, (rows - 1).bit_length())
    executed, skipped = _drive_loop(words, [seg_bits, 30, 30])
    assert skipped >= 4          # the window words' middle bytes are 0


@pytest.mark.parametrize("rbits", [4, 8])
def test_loop_on_wrappers_matches_lexsort(rbits):
    """The same loop on the public wrappers, which take their plain
    versions for CPU tensors."""
    n = 5000
    rng = np.random.default_rng(rbits)
    words = [(rng.integers(0, 5, n) << 25 | rng.integers(0, 3, n)
              ).astype(np.int32) for _ in range(3)]
    pay = np.arange(n, dtype=np.int32)
    cols = _cols(*words, pay)
    lookback = LookBack(n, len(pass_plan([30, 30, 30], rbits)), "cpu")

    def one_pass(src, key_col, shift, bits, digit_starts, dst):
        onesweep_pass(src, key_col, shift, bits, digit_starts, lookback, dst)

    sort_passes(cols, [30, 30, 30], rbits, digit_histograms, one_pass)
    lex_w, lex_p = _lexsort_words(words, pay, [30, 30, 30])
    for c, w in zip(cols, lex_w + [lex_p]):
        assert np.array_equal(c.numpy(), w)


# --- argument checks -----------------------------------------------------

@pytest.mark.parametrize("change,err", [
    (dict(words=[]), ValueError),
    (dict(words=[np.zeros(8, np.int32)] * 4, live_bits=8), ValueError),
    (dict(live_bits=[8, 8]), ValueError),
    (dict(live_bits=0), ValueError),
    (dict(live_bits=33), ValueError),
    (dict(rbits=9), ValueError),
    (dict(rbits=0), ValueError),
    (dict(words=[np.zeros(8, np.int64)]), TypeError),
    (dict(words=[np.zeros(8, np.int32), np.zeros(9, np.int32)],
          live_bits=8), TypeError),
])
def test_digit_histograms_rejects_bad_arguments(change, err):
    args = dict(words=[np.zeros(8, np.int32)], live_bits=8, rbits=8)
    args.update(change)
    words = [torch.from_numpy(w) for w in args["words"]]
    for fn in (digit_histograms, digit_histograms_reference):
        with pytest.raises(err):
            fn(words, args["live_bits"], args["rbits"])


@pytest.mark.parametrize("change,err", [
    (dict(cols=[]), ValueError),
    (dict(cols=[np.zeros(8, np.int32)] * 5), ValueError),
    (dict(key_col=2), ValueError),
    (dict(rbits=9), ValueError),
    (dict(shift=32), ValueError),
    (dict(cols=[np.zeros(8, np.int64)]), TypeError),
])
def test_onesweep_pass_rejects_bad_arguments(change, err):
    args = dict(cols=[np.zeros(8, np.int32)], key_col=0, shift=0, rbits=8)
    args.update(change)
    cols = [torch.from_numpy(c) for c in args["cols"]]
    starts = torch.zeros(1 << 8, dtype=torch.int32)
    with pytest.raises(err):
        onesweep_pass(cols, args["key_col"], args["shift"], args["rbits"],
                      starts, LookBack(8, 1, "cpu"))
    with pytest.raises(err):
        onesweep_pass_reference(cols, args["key_col"], args["shift"],
                                args["rbits"])


def test_radix_sort_words_rejects_bad_rbits():
    words = _cols(np.zeros(8, np.int32))
    with pytest.raises(ValueError):
        radix_sort_words(words, _cols(np.arange(8))[0], 30, rbits=9)


def test_onesweep_wrappers_have_no_fallback_for_other_devices():
    """Only CPU tensors take the plain versions; other devices that are
    not CUDA raise instead of computing somewhere else."""
    cols = [torch.zeros(64, dtype=torch.int32, device="meta")]
    before = launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        digit_histograms(cols, 30)
    with pytest.raises(ValueError, match="unsupported device"):
        onesweep_pass(cols, 0, 0, 8,
                      torch.zeros(256, dtype=torch.int32, device="meta"),
                      LookBack(64, 1, "meta"))
    assert launch_counts() == before


# --- on the card ---------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")


def _on_card(*arrays):
    return [c.cuda() for c in _cols(*arrays)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, TILE, 3 * TILE + 17, 1 << 16,
                               1 << 22])
@pytest.mark.parametrize("rbits,shift,key_col,n_cols",
                         [(4, 0, 0, 2), (4, 28, 1, 3), (8, 8, 0, 3),
                          (8, 24, 2, 4)])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "equal",
                                  "descending"])
def test_onesweep_pass_matches_plain_on_card(n, rbits, shift, key_col,
                                             n_cols, kind):
    _need_cuda()
    keys = _keys(kind, n, n + shift)
    others = [np.arange(n), keys ^ 0x5A5A, np.arange(n)[::-1]]
    arrays = others[:key_col] + [keys] + others[key_col:n_cols - 1]
    cols = _on_card(*arrays)
    before = launch_counts()["onesweep_pass"]
    got = onesweep_pass(cols, key_col, shift, rbits,
                        *_pass_args(cols, key_col, shift, rbits))
    assert launch_counts()["onesweep_pass"] == before + 1
    want = onesweep_pass_reference(cols, key_col, shift, rbits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["skewed", "equal"])
def test_onesweep_pass_is_deterministic_on_card(kind):
    """The same call three times gives the same output: the look-back's
    order of arrival does not leak into the result."""
    _need_cuda()
    n = (1 << 22) + 5
    keys = _keys(kind, n, 3)
    cols = _on_card(keys, np.arange(n), keys ^ 77)
    outs = [onesweep_pass(cols, 0, 8, 8, *_pass_args(cols, 0, 8, 8))
            for _ in range(3)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for g, w in zip(out, outs[0]):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, (1 << 20) + 3])
@pytest.mark.parametrize("live_bits", [[30], [5, 17], [28, 30, 30],
                                       [32, 3, 8]])
@pytest.mark.parametrize("rbits", [4, 8])
@pytest.mark.parametrize("kind", ["uniform", "skewed", "equal"])
def test_digit_histograms_matches_plain_on_card(n, live_bits, rbits, kind):
    _need_cuda()
    words = _on_card(*[_keys(kind, n, n + i) for i in range(len(live_bits))])
    before = launch_counts()["digit_histograms"]
    got = digit_histograms(words, live_bits, rbits)
    assert launch_counts()["digit_histograms"] == before + 1
    want = digit_histograms_reference(words, live_bits, rbits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("live_bits,kinds", [
    ([30], ["uniform"]),
    ([32, 17], ["equal", "uniform"]),
    ([28, 30, 30], ["skewed", "uniform", "equal"]),
    ([5, 32, 8], ["descending", "skewed", "uniform"]),
])
@pytest.mark.parametrize("rbits", [4, 8])
def test_radix_sort_words_skips_passes_on_card(live_bits, kinds, rbits):
    """1-3 words with per-word live bits; an all-equal word skips all its
    passes. The kernels run, K2 and K3 do not, and the result equals the
    plain sort."""
    _need_cuda()
    n = 300_001
    words = [_keys(k, n, i) for i, k in enumerate(kinds)]
    pay = np.arange(n, dtype=np.int32)
    plan = pass_plan(live_bits, rbits)
    before = {**launch_counts(), **pass_counts()}
    got_w, got_p = radix_sort_words(_on_card(*words), _cols(pay)[0].cuda(),
                                    live_bits, rbits)
    got = {k: v - before[k]
           for k, v in {**launch_counts(), **pass_counts()}.items()}
    run, skipped = got["passes_run"], got["passes_skipped"]
    assert run + skipped == len(plan)
    if "equal" in kinds:
        assert skipped >= -(-live_bits[kinds.index("equal")] // rbits)
    assert got["onesweep_pass"] == run
    assert got["digit_histograms"] == 1
    assert got["block_digit_sort"] == got["place_runs"] == 0
    want_w, want_p = radix_sort_words_reference(
        _on_card(*words), _cols(pay)[0].cuda(), live_bits)
    torch.cuda.synchronize()
    assert torch.equal(got_p, want_p)
    for g, w in zip(got_w, want_w):
        assert torch.equal(g, w)


def _card_cols(n_cols: int, key_col: int, keys: np.ndarray):
    n = len(keys)
    others = [np.arange(n), keys ^ 0x5A5A, np.arange(n)[::-1]]
    return _on_card(*(others[:key_col] + [keys]
                      + others[key_col:n_cols - 1]))


def _three_calls_match_plain(cols, key_col, shift, rbits):
    """Three calls of the kernel, each equal to the plain pass."""
    want = onesweep_pass_reference(cols, key_col, shift, rbits)
    for _ in range(3):
        got = onesweep_pass(cols, key_col, shift, rbits,
                            *_pass_args(cols, key_col, shift, rbits))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", [1, 2, 3, 4])
@pytest.mark.parametrize("tiles,delta", [(1, -1), (1, 0), (1, 1), (5, -1),
                                         (5, 0), (5, 1)])
@pytest.mark.parametrize("rbits,shift", [(1, 31), (4, 3), (8, 8)])
def test_onesweep_pass_at_the_tile_edges_on_card(n_cols, tiles, delta,
                                                 rbits, shift):
    """n at one and five of the pass's own tiles, +-1, on 1-4 columns and
    1-, 4- and 8-bit digits: equal to the plain pass three times."""
    _need_cuda()
    n = tiles * tile_elems(n_cols) + delta
    keys = _keys("uniform", n, n + rbits)
    key_col = n_cols - 1
    _three_calls_match_plain(_card_cols(n_cols, key_col, keys), key_col,
                             shift, rbits)


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 1, 1, 1), (2, 2, 2, 2),
                                     (3, 3, 3, 3), (1, 0, 3, 2)])
@pytest.mark.parametrize("n_cols", [3, 4])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_onesweep_pass_on_misaligned_slices_on_card(offsets, n_cols, kind):
    """Source columns sliced at 1-3 elements past a 16-byte boundary, as
    an MSD bucket's slices are, the same or different a column."""
    _need_cuda()
    n = 3 * tile_elems(n_cols) + 777
    keys = _keys(kind, n, 7)
    full = _card_cols(n_cols, 0, np.concatenate([keys, keys[:8]]))
    cols = [c[o:o + n] for c, o in zip(full, offsets)]
    assert [c.data_ptr() % 16 for c in cols] == [4 * o for o in
                                                 offsets[:n_cols]]
    _three_calls_match_plain(cols, 0, 8, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", [2, 4])
@pytest.mark.parametrize("rbits", [4, 8])
def test_onesweep_pass_into_longer_outputs_on_card(n_cols, rbits):
    """The MSD scatter's form: each digit's run at a start of its own in
    outputs longer than the input, bounded by the digit counts; what
    lies between the runs is left as it was."""
    _need_cuda()
    n = 4 * tile_elems(n_cols) + 91
    keys = _keys("skewed", n, 5)
    cols = _card_cols(n_cols, 0, keys)
    digit = ((cols[0].long() & 0xFFFFFFFF) >> 4) & ((1 << rbits) - 1)
    counts = torch.bincount(digit, minlength=1 << rbits)
    gaps = torch.arange(1 << rbits, device="cuda") * 3 + 1
    starts = (torch.cumsum(counts + gaps, 0) - counts).to(torch.int32)
    size = int(starts[-1] + counts[-1]) + 5
    want = [torch.full((size,), -7, dtype=torch.int32, device="cuda")
            for _ in cols]
    onesweep_pass_reference(cols, 0, 4, rbits, want, starts)
    for _ in range(3):
        out = [torch.full_like(w, -7) for w in want]
        onesweep_pass(cols, 0, 4, rbits, starts, LookBack(n, 1, "cuda"),
                      out, counts.tolist())
        torch.cuda.synchronize()
        for g, w in zip(out, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cols", [1, 2, 3, 4])
@pytest.mark.parametrize("same", [True, False])
def test_onesweep_pass_with_one_digit_a_tile_on_card(n_cols, same):
    """Every tile holds one digit, the same in all tiles or another in
    each: the look-backs add counts of 0 and of whole tiles."""
    _need_cuda()
    tile = tile_elems(n_cols)
    n = 40 * tile
    t = np.arange(n) // tile
    keys = ((np.full(n, 77) if same else (t * 37) % 256) << 16
            | np.arange(n) % 5).astype(np.int32)
    _three_calls_match_plain(_card_cols(n_cols, 0, keys), 0, 16, 8)
