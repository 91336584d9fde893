"""The post-sort pass (``kernels/post_sort.py``).

``post_sort_reference``, what ``post_sort`` runs for CPU tensors, is
held against a per-row oracle that compares unpacked symbols, exactly.
The CUDA cases hold the hand-written kernel byte for byte to the plain
version on the card (tie flags, stats and LCP) and skip where there is
none. No JAX here: the card's cases run in this file.
"""

import numpy as np
import pytest
import torch

from hpc_suffix_array_tpu_torch.kernels import launch_counts
from hpc_suffix_array_tpu_torch.kernels import post_sort as kps
from hpc_suffix_array_tpu_torch.kernels.post_sort import (
    post_sort, post_sort_bytes, post_sort_reference)
from hpc_suffix_array_tpu_torch.utils.profiling import record

BIG = 1 << 30


def _pack(codes: np.ndarray, nw: int, spw: int, bits: int) -> list:
    """int32 key words of (m, nw * spw) codes, first symbol highest."""
    words = []
    for w in range(nw):
        acc = np.zeros(codes.shape[0], np.int64)
        for k in range(spw):
            acc = (acc << bits) | codes[:, w * spw + k]
        words.append(acc.astype(np.int32))
    return words


def _sorted_words(rng, m, nw, spw, bits, sigma, depth, top=False):
    """m sorted keys whose first ``depth`` symbols are drawn from
    ``sigma`` codes (the rest 0), so that many rows tie; ``top`` puts the
    largest code 2^bits - 1 in the first symbol of about half the rows."""
    codes = np.zeros((m, nw * spw), np.int64)
    codes[:, :depth] = rng.integers(0, sigma, (m, depth))
    if top:
        codes[:, 0] = np.where(rng.random(m) < 0.5, (1 << bits) - 1,
                               codes[:, 0])
    words = _pack(codes, nw, spw, bits)
    order = np.lexsort(words[::-1])
    return [w[order] for w in words]


def _chain_idx(words, n, deltas):
    """Positions descending along each tie run by the run's delta (from
    ``deltas``, in turn), each run starting below n."""
    m = words[0].shape[0]
    idx = np.empty(m, np.int64)
    run, d = 0, deltas[0]
    for j in range(m):
        same = j > 0 and all(w[j] == w[j - 1] for w in words)
        if same:
            idx[j] = idx[j - 1] - d
        else:
            d = deltas[run % len(deltas)]
            run += 1
            idx[j] = n - 1 - j
    assert idx.min() >= 0
    return idx.astype(np.int32)


def _case(name):
    """(words, idx, n, spw, bits, desc, prev) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "asc-2w":
        words = _sorted_words(rng, 300, 2, 5, 6, 3, 7)
        return words, rng.choice(1000, 300, replace=False), 1000, 5, 6, \
            False, None
    if name == "asc-3w":
        words = _sorted_words(rng, 300, 3, 10, 3, 2, 12)
        return words, rng.choice(5000, 300, replace=False), 5000, 10, 3, \
            False, None
    if name == "asc-prev":
        words = _sorted_words(rng, 200, 2, 5, 6, 3, 7)
        prev = [words[0][0], words[1][0] ^ 1]
        return words, rng.choice(1000, 200, replace=False), 1000, 5, 6, \
            False, prev
    if name == "m1":
        words = _sorted_words(rng, 1, 2, 4, 7, 100, 8)
        return words, np.array([17], np.int32), 40, 4, 7, False, None
    if name == "m1-prev-chain":
        words = _sorted_words(rng, 1, 3, 4, 7, 100, 8)
        return words, np.array([17], np.int32), 40, 4, 7, True, \
            [words[0][0], words[1][0], words[2][0] ^ 5]
    if name == "all-tied":
        words = [np.full(64, 12345, np.int32), np.full(64, 99, np.int32)]
        return words, (np.arange(64) * 3).astype(np.int32), 200, 5, 6, \
            False, None
    if name == "none-tied":
        codes = np.arange(256)[:, None] >> np.array([6, 4, 2, 0])
        codes = np.concatenate([codes & 3, np.zeros((256, 4), int)], 1)
        words = _pack(codes, 2, 4, 2)
        return words, rng.permutation(256).astype(np.int32), 256, 4, 2, \
            False, None
    if name == "negative-deltas":
        words = _sorted_words(rng, 200, 2, 5, 6, 2, 3)
        return words, np.arange(199, -1, -1, dtype=np.int32), 200, 5, 6, \
            False, None
    if name == "top-code":
        words = _sorted_words(rng, 300, 2, 5, 6, 4, 7, top=True)
        return words, rng.choice(1000, 300, replace=False), 1000, 5, 6, \
            False, [words[0][0] >> 1, words[1][0]]
    if name == "chain-uniform":
        words = _sorted_words(rng, 300, 2, 5, 6, 2, 4)
        return words, _chain_idx(words, 10_000, [7]), 10_000, 5, 6, True, \
            None
    if name == "chain-nonuniform":
        words = _sorted_words(rng, 300, 2, 5, 6, 2, 4)
        return words, _chain_idx(words, 10_000, [7, 3, 11]), 10_000, 5, 6, \
            True, None
    if name == "chain-3w-prev":
        words = _sorted_words(rng, 300, 3, 10, 3, 2, 11)
        prev = [w[0] for w in words]                 # equal to row 0
        return words, _chain_idx(words, 20_000, [1]), 20_000, 10, 3, True, \
            prev
    raise KeyError(name)


CASES = ["asc-2w", "asc-3w", "asc-prev", "m1", "m1-prev-chain", "all-tied",
         "none-tied", "negative-deltas", "top-code", "chain-uniform",
         "chain-nonuniform", "chain-3w-prev"]


def _oracle(words, idx, n, spw, bits, desc, want_lcp, prev):
    """Row by row on Python ints: (tie, stats, lcp or None)."""
    nw, m = len(words), len(idx)
    mask = (1 << bits) - 1

    def syms(key):
        return [(key[w] >> bits * (spw - 1 - k)) & mask
                for w in range(nw) for k in range(spw)]

    tie, lcp, deltas = [], [], []
    for j in range(m):
        cur = [int(w[j]) for w in words]
        before = ([int(w[j - 1]) for w in words] if j
                  else None if prev is None else [int(p) for p in prev])
        t = j > 0 and before == cur
        tie.append(t)
        if t:
            d = int(idx[j]) - int(idx[j - 1])
            deltas.append(-d if desc else d)
        if before is None:
            length = 0                     # the sentinel is below every code
        else:
            a, b = syms(before), syms(cur)
            length = next((k for k in range(nw * spw) if a[k] != b[k]),
                          nw * spw)
        lcp.append(n - int(idx[j - 1]) if desc and t else length)
    dmax, dmin = max([0] + deltas), min([BIG] + deltas)
    ok = not deltas or (dmin == dmax and dmax >= 1)
    return tie, [len(deltas), dmax, int(ok)], (lcp if want_lcp else None)


def _tensors(case, device="cpu"):
    words, idx, n, spw, bits, desc, prev = case
    to = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(device)
    heads = None if prev is None else [to([p]) for p in prev]
    return [to(w) for w in words], to(idx), n, spw, bits, desc, heads


def _check(got, want):
    tie, stats, lcp = got
    assert tie.dtype == torch.bool and stats.dtype == torch.int64
    assert tie.tolist() == want[0]
    assert stats.tolist() == want[1]
    if want[2] is None:
        assert lcp is None
    else:
        assert lcp.dtype == torch.int32 and lcp.tolist() == want[2]


@pytest.mark.parametrize("want_lcp", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_reference_matches_row_oracle(name, want_lcp):
    case = _case(name)
    words, idx, n, spw, bits, desc, prev = case
    want = _oracle(words, idx, n, spw, bits, desc, want_lcp, prev)
    args = _tensors(case)
    got = post_sort_reference(*args[:6], want_lcp, args[6])
    _check(got, want)


def test_cases_cover_the_stats_edges():
    """The cases reach what the stats must keep apart: no tie, a uniform
    chain, dmax at its floor of 0 with delta_ok false, and a non-uniform
    chain."""
    stats = {}
    for name in CASES:
        words, idx, n, spw, bits, desc, prev = _case(name)
        stats[name] = _oracle(words, idx, n, spw, bits, desc, False,
                              prev)[1]
    assert stats["none-tied"] == [0, 0, 1] and stats["m1"] == [0, 0, 1]
    assert stats["all-tied"] == [63, 3, 1]
    assert stats["negative-deltas"][1:] == [0, 0]
    assert stats["negative-deltas"][0] > 0
    assert stats["chain-uniform"][1:] == [7, 1]
    assert stats["chain-nonuniform"][2] == 0
    assert stats["chain-3w-prev"][1:] == [1, 1]


def test_reference_writes_into_given_outputs():
    """Outputs given as a bucket's rows of whole-text arrays: only those
    rows change, and the results are those rows."""
    words, idx, n, spw, bits, desc, prev = _tensors(_case("asc-2w"))
    m = idx.shape[0]
    tie_all = torch.ones(m + 10, dtype=torch.bool)
    lcp_all = torch.full((m + 10,), -7, dtype=torch.int32)
    want = post_sort_reference(words, idx, n, spw, bits, desc, True, prev)
    got = post_sort_reference(words, idx, n, spw, bits, desc, True, prev,
                              tie_out=tie_all[3:3 + m],
                              lcp_out=lcp_all[3:3 + m])
    assert got[0].data_ptr() == tie_all[3:].data_ptr()
    assert got[2].data_ptr() == lcp_all[3:].data_ptr()
    assert torch.equal(tie_all[3:3 + m], want[0])
    assert torch.equal(lcp_all[3:3 + m], want[2])
    assert torch.equal(got[1], want[1])
    assert tie_all[:3].all() and tie_all[3 + m:].all()
    assert (lcp_all[:3] == -7).all() and (lcp_all[3 + m:] == -7).all()


def test_dispatcher_runs_the_reference_on_cpu(monkeypatch):
    calls = []
    real = kps.post_sort_reference

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    def no_kernel(*args, **kw):
        raise AssertionError("the kernel's launcher ran on the CPU")

    monkeypatch.setattr(kps, "post_sort_reference", spy)
    monkeypatch.setattr(kps, "_launch", no_kernel)
    case = _tensors(_case("chain-uniform"))
    before = launch_counts()["post_sort"]
    got = post_sort(*case[:6], True, case[6])
    assert calls == [1] and launch_counts()["post_sort"] == before
    _check(got, _oracle(*_case("chain-uniform")[:6], True, None))


@pytest.mark.parametrize("nw,want_lcp", [(2, True), (2, False), (3, True)])
def test_post_sort_bytes_equal_the_formula_on_the_cpu(nw, want_lcp):
    name = "asc-2w" if nw == 2 else "asc-3w"
    words, idx, n, spw, bits, desc, prev = _tensors(_case(name))
    m = idx.shape[0]
    with record("t", own=True) as rec:
        post_sort(words, idx, n, spw, bits, desc, want_lcp, prev)
    assert rec.counters == {"post_sort_bytes": post_sort_bytes(m, nw,
                                                               want_lcp)}
    assert post_sort_bytes(m, nw, want_lcp) == m * (4 * nw + 4 + 1
                                                   + 4 * want_lcp)


def _bad(change):
    words, idx, n, spw, bits, desc, prev = _tensors(_case("asc-2w"))
    kw = {"tie_out": None, "lcp_out": None, "prev": prev}
    if change == "short_word":
        words[1] = words[1][:-1]
    elif change == "int64_idx":
        idx = idx.long()
    elif change == "empty":
        words, idx = [w[:0] for w in words], idx[:0]
    elif change == "prev_words":
        kw["prev"] = [torch.zeros(1, dtype=torch.int32)]
    elif change == "tie_out":
        kw["tie_out"] = torch.zeros(idx.shape[0], dtype=torch.int32)
    elif change == "lcp_out":
        kw["lcp_out"] = torch.zeros(idx.shape[0] + 1, dtype=torch.int32)
    return (words, idx, n, spw, bits, desc, True), kw


@pytest.mark.parametrize("change,err", [
    ("short_word", TypeError), ("int64_idx", TypeError),
    ("empty", ValueError), ("prev_words", ValueError),
    ("tie_out", TypeError), ("lcp_out", TypeError)])
def test_post_sort_rejects_bad_arguments(change, err):
    args, kw = _bad(change)
    for fn in (post_sort, post_sort_reference):
        with pytest.raises(err):
            fn(*args, **kw)


def test_post_sort_has_no_fallback_for_other_devices():
    """Only CPU tensors take the plain pass; a device that is neither
    CPU nor CUDA raises instead of computing somewhere else."""
    words = [torch.zeros(8, dtype=torch.int32, device="meta")] * 2
    idx = torch.zeros(8, dtype=torch.int32, device="meta")
    before = launch_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        post_sort(words, idx, 8, 5, 6, False, True)
    assert launch_counts() == before


# --- on the card --------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")


def _same(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    if want[2] is None:
        assert got[2] is None
    else:
        assert torch.equal(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("want_lcp", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_reference_on_card(name, want_lcp):
    _need_cuda()
    words, idx, n, spw, bits, desc, prev = _tensors(_case(name), "cuda")
    got = post_sort(words, idx, n, spw, bits, desc, want_lcp, prev)
    want = post_sort_reference(words, idx, n, spw, bits, desc, want_lcp,
                               prev)
    _same(got, want)
    oracle = _oracle(*_case(name)[:6], want_lcp, _case(name)[6])
    _check(tuple(t if t is None else t.cpu() for t in got), oracle)


def _card_keys(m: int, nw: int, seed: int):
    """m rows of nw words on the card with long tie runs (k0 sorted with
    about m / 8 distinct values, the others 0 or 1) and distinct
    positions."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    k0 = torch.randint(0, max(m // 8, 1), (m,), generator=g, device="cuda",
                       dtype=torch.int32).sort().values
    words = [k0] + [torch.randint(0, 2, (m,), generator=g, device="cuda",
                                  dtype=torch.int32) for _ in range(nw - 1)]
    idx = torch.randperm(m, generator=g, device="cuda").to(torch.int32)
    return words, idx


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 31, (1 << 20) + 17, 1 << 27])
@pytest.mark.parametrize("nw,desc", [(2, False), (2, True), (3, False)])
def test_kernel_sizes_on_card(m, nw, desc):
    _need_cuda()
    words, idx = _card_keys(m, nw, m + nw)
    for want_lcp in (True, False):
        got = post_sort(words, idx, m + 5, 5, 6, desc, want_lcp)
        want = post_sort_reference(words, idx, m + 5, 5, 6, desc, want_lcp)
        _same(got, want)
    del words, idx
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, 0, 0), (1, 1, 1), (2, 2, 2),
                                     (3, 3, 3), (5, 5, 5), (1, 2, 3),
                                     (0, 0, 1), (4, 4, 0)])
def test_kernel_writes_into_slices_on_card(offsets):
    """Columns, flags and LCP as a bucket's rows of whole-text slabs (the
    MSD's ``tie[a:z]`` and ``bid_s[a:z]``): the same misalignment
    everywhere takes the wide path, mixed ones the row-by-row path; rows
    outside the slice stay as they were."""
    _need_cuda()
    m, nw = 10_000 + 3, 2
    a_in, a_tie, a_lcp = offsets
    words, idx = _card_keys(m, nw, sum(offsets))
    slabs = [torch.full((m + 16,), -9, dtype=torch.int32, device="cuda")
             for _ in range(nw + 1)]
    for s, col in zip(slabs, [*words, idx]):
        s[a_in:a_in + m] = col
    cols = [s[a_in:a_in + m] for s in slabs]
    tie_all = torch.ones(m + 16, dtype=torch.bool, device="cuda")
    lcp_all = torch.full((m + 16,), -7, dtype=torch.int32, device="cuda")
    prev = [torch.tensor([c], dtype=torch.int32, device="cuda")
            for c in (int(words[0][0]) - 1, 0)]
    got = post_sort(cols[:nw], cols[nw], 2 * m, 5, 6, False, True, prev,
                    tie_out=tie_all[a_tie:a_tie + m],
                    lcp_out=lcp_all[a_lcp:a_lcp + m])
    want = post_sort_reference(words, idx, 2 * m, 5, 6, False, True, prev)
    _same(got, want)
    assert tie_all[:a_tie].all() and tie_all[a_tie + m:].all()
    assert (lcp_all[:a_lcp] == -7).all() and (lcp_all[a_lcp + m:] == -7).all()


@pytest.mark.cuda
@pytest.mark.parametrize("desc", [False, True])
def test_kernel_prev_from_another_tensor_on_card(desc):
    """``prev`` as the MSD gives it: the last row of the previous
    bucket's columns, read on the device."""
    _need_cuda()
    before_words, _ = _card_keys(5000, 2, 1)
    words, idx = _card_keys(7000, 2, 2)
    words[0] += int(before_words[0][-1])            # keeps row 0 above it
    prev = [w[-1:] for w in before_words]
    got = post_sort(words, idx, 20_000, 5, 6, desc, True, prev)
    want = post_sort_reference(words, idx, 20_000, 5, 6, desc, True, prev)
    _same(got, want)


@pytest.mark.cuda
def test_kernel_counts_one_launch_on_card():
    _need_cuda()
    words, idx, n, spw, bits, desc, prev = _tensors(_case("asc-2w"), "cuda")
    before = launch_counts()["post_sort"]
    with record("t", own=True) as rec:
        post_sort(words, idx, n, spw, bits, desc, True, prev)
    torch.cuda.synchronize()
    assert launch_counts()["post_sort"] == before + 1
    assert rec.counters == {
        "launches: post_sort": 1,
        "post_sort_bytes": post_sort_bytes(idx.shape[0], 2, True)}
