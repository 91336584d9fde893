"""The exact host residue closer (``core/bigsort.py::_resolve_residue_host``).

Every case is made with numpy from a seed. The closer's order and every
LCP patch are held, exactly, against an oracle that sorts each group
pair by pair with ``_suffix_less`` and takes each adjacent pair's LCP
with ``_suffix_lcp``. Groups are either given by head flags and
proven tied through a depth (what the refinement hands over) or, with
``heads=None``, runs of consecutive slots read from depth 0.
"""

import functools

import numpy as np
import pytest

import hpc_suffix_array_tpu_torch.core.bigsort as tbs
from hpc_suffix_array_tpu_torch.utils.profiling import record

DNA = np.frombuffer(b"ACGT", np.uint8)
ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)


def _oracle(arr, slots, idxs, heads):
    """(slots, idx, lcp slots, lcp values) by pairwise comparison, each
    group sorted on its own."""
    n = len(arr)
    order = np.argsort(slots, kind="stable")
    slots, out = slots[order], idxs[order].copy()
    heads = heads[order].copy()
    heads[0] = True
    starts = list(np.flatnonzero(heads)) + [len(slots)]
    ls, lv = [], []
    for a, b in zip(starts[:-1], starts[1:]):
        out[a:b] = sorted(out[a:b].tolist(), key=functools.cmp_to_key(
            lambda x, y: -1 if tbs._suffix_less(arr, x, y, n) else 1))
        for j in range(a + 1, b):
            ls.append(slots[j])
            lv.append(tbs._suffix_lcp(arr, int(out[j - 1]), int(out[j]), n))
    return (slots, out, np.array(ls, np.int64), np.array(lv, np.int32))


def _runs(slots):
    return np.r_[True, np.diff(slots) != 1]


def _groups(arr, members, d, rng, gap=False):
    """(slots, idxs, heads) of ``members`` grouped by their first ``d``
    bytes (every member at least d long), groups in suffix order, rows
    shuffled inside each group; with ``gap`` a free slot after each
    group, else the groups touch."""
    n = len(arr)
    members = np.array(sorted(members, key=lambda i: arr[i:].tobytes()))
    assert (n - members >= d).all()
    keys = [arr[i:i + d].tobytes() for i in members]
    heads = np.r_[True, [keys[i] != keys[i - 1]
                         for i in range(1, len(keys))]].astype(bool)
    gid = np.cumsum(heads)
    idxs = members[np.lexsort((rng.random(len(members)), gid))]
    slots = np.arange(len(members), dtype=np.int64) + 37
    if gap:
        slots += gid
    return slots, idxs.astype(np.int32), heads


def _check(arr, slots, idxs, heads, depth, want_lcp=True, view=None):
    got = tbs._resolve_residue_host(
        arr if view is None else view, slots, idxs, len(arr),
        want_lcp=want_lcp, heads=heads, depth=depth)
    want = _oracle(arr, slots, idxs, _runs(slots) if heads is None
                   else heads)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    if want_lcp:
        assert got[2].dtype == np.int64 and got[3].dtype == np.int32
        assert np.array_equal(got[2], want[2])
        assert np.array_equal(got[3], want[3])
    else:
        assert len(got[2]) == len(got[3]) == 0
    return got


# --- the cases ------------------------------------------------------------

def _touching_segments():
    """Two segments proven tied through d = 300 whose slot ranges touch;
    their common prefix is 150 < d, and the second's blocks are smaller,
    so merging them would reorder across the boundary."""
    rng = np.random.default_rng(1)
    arr = DNA[rng.integers(0, 4, 40_000)].copy()
    x = DNA[rng.integers(0, 4, 400)].copy()
    x[150] = ord("T")
    y = x.copy()
    y[150] = ord("A")
    y[151:] = DNA[rng.integers(0, 4, 249)]
    a_sites, b_sites = [1000, 9000, 17000, 25000], [5000, 13000, 21000]
    for s in a_sites:
        arr[s:s + 400] = x
    for s in b_sites:
        arr[s:s + 400] = y
    a = np.array(a_sites)[rng.permutation(4)]
    b = np.array(b_sites)[rng.permutation(3)]
    slots = np.arange(100, 107, dtype=np.int64)
    idxs = np.r_[a, b].astype(np.int32)
    heads = np.r_[True, False, False, False, True, False, False]
    return arr, slots, idxs, heads, 300


def _n_runs():
    """One group of 20+ members: suffixes inside runs of N of different
    lengths, each with at least 16 N ahead (tied through 16)."""
    rng = np.random.default_rng(2)
    arr = DNA[rng.integers(0, 4, 30_000)].copy()
    members = []
    for k, length in enumerate((20, 33, 47, 64, 90, 130, 16, 700)):
        s = 1000 + 3000 * k
        arr[s:s + length] = ord("N")
        members += range(s, s + length - 15)
    arr[-50:] = ord("N")                 # a run that ends the text
    members += range(len(arr) - 50, len(arr) - 15)
    members = np.array(members)
    slots = np.arange(len(members), dtype=np.int64)
    heads = np.zeros(len(members), bool)
    heads[0] = True
    return arr, slots, members[rng.permutation(len(members))].astype(
        np.int32), heads, 16


def _ends_inside_window():
    """Zero bytes: suffixes in a zero run that ends the text against
    suffixes in zero runs followed by more bytes (the shorter suffix that
    is a prefix orders first, and its LCP is its length); groups by their
    first 8 bytes."""
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, 8000).astype(np.uint8)
    arr[-40:] = 0
    arr[2000:2030] = 0
    arr[3000:3070] = 0
    arr[3070] = 1
    arr[5000:5100] = np.tile(np.frombuffer(b"ab", np.uint8), 50)
    arr[-100:-40] = np.tile(np.frombuffer(b"ab", np.uint8), 30)
    members = [i for i in range(len(arr) - 8)
               if not arr[i:i + 8].any()
               or arr[i:i + 8].tobytes() in (b"abababab", b"babababa")]
    members += range(len(arr) - 8, len(arr))      # shorter than 8
    return arr, members


def _deep_copy():
    """A 5000-byte copy at three sites: ties deeper than four doubled
    windows (64 + 128 + 256 + 512 bytes)."""
    rng = np.random.default_rng(4)
    arr = ALNUM[rng.integers(0, 62, 40_000)].copy()
    blk = arr[100:5100].copy()
    for s in (12_000, 26_000):
        arr[s:s + 5000] = blk
    members = [s + k for s in (100, 12_000, 26_000) for k in range(40)]
    return arr, members


@pytest.mark.parametrize("want_lcp", [True, False])
def test_touching_segments_stay_apart(want_lcp):
    arr, slots, idxs, heads, d = _touching_segments()
    got = _check(arr, slots, idxs, heads, d, want_lcp)
    # The second segment starts at slot 104 and keeps its place there;
    # the boundary's LCP is the refinement's, not patched here.
    assert set(got[1][4:]) == {5000, 13000, 21000}
    assert 104 not in got[2]
    merged = tbs._resolve_residue_host(arr, slots, idxs, len(arr))
    assert not np.array_equal(merged[1], got[1])


@pytest.mark.parametrize("want_lcp", [True, False])
def test_one_group_of_n_runs(want_lcp):
    arr, slots, idxs, heads, d = _n_runs()
    assert len(slots) >= 20
    _check(arr, slots, idxs, heads, d, want_lcp)


@pytest.mark.parametrize("gap", [False, True])
def test_suffixes_that_end_inside_a_window(gap):
    arr, members = _ends_inside_window()
    slots, idxs, heads = _groups(arr, members, 0, np.random.default_rng(5),
                                 gap)
    _check(arr, slots, idxs, None, 0)
    long = [i for i in members if len(arr) - i >= 8]
    slots, idxs, heads = _groups(arr, long, 8, np.random.default_rng(6), gap)
    _check(arr, slots, idxs, heads, 8)


@pytest.mark.parametrize("depth", [0, 16, 4900])
def test_ties_deeper_than_four_doubled_windows(depth):
    arr, members = _deep_copy()
    if depth > 16:
        members = [s + k for s in (100, 12_000, 26_000) for k in range(3)]
    slots, idxs, heads = _groups(arr, members, depth,
                                 np.random.default_rng(7))
    with record("t", own=True) as rec:
        got = _check(arr, slots, idxs, heads, depth)
    assert rec.counters["residue_members"] == len(members)
    assert rec.counters["residue_steps"] >= (5 if depth < 100 else 1)
    assert got[3].max() >= 4900


@pytest.mark.parametrize("seed", range(6))
def test_heads_none_gives_consecutive_slot_groups(seed):
    """heads=None: groups are runs of consecutive slots from depth 0
    (touching true groups merge), as before the closer took heads."""
    rng = np.random.default_rng(100 + seed)
    arr = DNA[rng.integers(0, 2 + seed % 3, 3000)].copy()
    s0, s1 = rng.integers(0, 1500, 2)
    arr[s1:s1 + 500] = arr[s0:s0 + 500].copy()
    members = rng.choice(2990, 400, replace=False)
    slots, idxs, heads = _groups(arr, members, 4, rng, gap=seed % 2 == 0)
    _check(arr, slots, idxs, None, 0, want_lcp=seed < 4)


@pytest.mark.parametrize("seed", range(8))
def test_random_groups_tied_through_a_depth(seed):
    rng = np.random.default_rng(200 + seed)
    n = int(rng.integers(500, 6000))
    arr = DNA[rng.integers(0, 1 + seed % 4, n)].copy()
    if seed % 2:
        L = int(rng.integers(100, n // 3))
        s0, s1 = rng.integers(0, n - L, 2)
        arr[s1:s1 + L] = arr[s0:s0 + L].copy()
    d = int(rng.integers(0, 80))
    members = [i for i in range(n) if n - i >= d]
    slots, idxs, heads = _groups(arr, members, d, rng, gap=seed % 3 == 0)
    _check(arr, slots, idxs, heads, d, want_lcp=seed != 5)


class _BoundedView:
    """A ``_GatheredView``-style view: text only through ``fetch``,
    ``DEEP_WIN`` bytes deep at most; records every window it serves."""

    DEEP_WIN = 4096

    def __init__(self, arr):
        self.inner = tbs._ArrView(arr, len(arr))
        self.calls = []

    def fetch(self, starts, K):
        self.calls.append((np.array(starts), K))
        return self.inner.fetch(starts, K)


def test_bounded_view_resolves_within_its_depth():
    rng = np.random.default_rng(8)
    arr = ALNUM[rng.integers(0, 62, 30_000)].copy()
    arr[20_000:24_000] = arr[1000:5000]
    members = [1000 + k for k in range(30)] + [20_000 + k for k in range(30)]
    slots, idxs, heads = _groups(arr, members, 0, rng)
    view = _BoundedView(arr)
    _check(arr, slots, idxs, None, 0, view=view)
    assert sum(K for _, K in view.calls) <= 4096


def test_bounded_view_raises_past_its_depth():
    arr, members = _deep_copy()
    slots, idxs, heads = _groups(arr, members, 0, np.random.default_rng(9))
    with pytest.raises(tbs.ResidueDepthError, match="tie past 4096 bytes"):
        tbs._resolve_residue_host(_BoundedView(arr), slots, idxs, len(arr),
                                  want_lcp=True)


def test_reads_start_at_the_proven_depth():
    """No window starts above a member's proven depth, and the windows
    double from RESIDUE_WIN."""
    arr, members = _deep_copy()
    slots, idxs, heads = _groups(arr, members, 300,
                                 np.random.default_rng(10))
    view = _BoundedView(arr)
    view.DEEP_WIN = None
    _check(arr, slots, idxs, heads, 300, view=view)
    firsts = view.calls[0][0]
    assert np.array_equal(np.sort(firsts), np.sort(idxs + 300))
    widths = [K for _, K in view.calls]
    assert widths[0] == tbs.RESIDUE_WIN
    assert all(b == 2 * a for a, b in zip(widths, widths[1:]))


def test_arr_view_fetch_at_and_past_the_end():
    arr = np.arange(1, 101, dtype=np.uint8)
    win = tbs._ArrView(arr, 100).fetch(np.array([0, 36, 90, 99, 100]), 64)
    assert win.dtype == np.uint8 and win.shape == (5, 64)
    assert np.array_equal(win[0], arr[:64])
    assert np.array_equal(win[1], arr[36:100])
    assert np.array_equal(win[2], np.r_[arr[90:], np.zeros(54, np.uint8)])
    assert win[3, 0] == 100 and not win[3, 1:].any()
    assert not win[4].any()
    assert not tbs._ArrView(arr[:10], 10).fetch(np.array([3]), 64)[0, 7:].any()


def test_empty_and_singleton_groups():
    arr = DNA[np.random.default_rng(11).integers(0, 4, 500)].copy()
    got = tbs._resolve_residue_host(arr, np.zeros(0, np.int64),
                                    np.zeros(0, np.int32), 500, True)
    assert all(len(x) == 0 for x in got)
    slots = np.array([5, 9, 20], np.int64)
    idxs = np.array([7, 3, 100], np.int32)
    got = tbs._resolve_residue_host(arr, slots, idxs, 500, True)
    assert np.array_equal(got[1], idxs) and len(got[2]) == 0
