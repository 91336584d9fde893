"""The refinement's word-round kernels (``kernels/refine_round.py``).

``round_gather_reference`` and ``round_split_reference``, what the two
dispatchers run for CPU tensors, are held against per-row oracles on
unpacked symbols: the gathered words against the text's symbols at each
row's window, and the split's heads, patches, tied count and ordinals
against a row-by-row comparison and a count. The CUDA cases hold the
hand-written kernels byte for byte to the plain versions on the card and
skip where there is none. No JAX here: the card's cases run in this file.
"""

import numpy as np
import pytest
import torch

import hpc_suffix_array_tpu_torch as tsa
import hpc_suffix_array_tpu_torch.core.refine as trf
from hpc_suffix_array_tpu_torch.core.oracle import (
    lcp_oracle, suffix_array_oracle)
from hpc_suffix_array_tpu_torch.datasets.generate import generate_words_text
from hpc_suffix_array_tpu_torch.kernels import launch_counts
from hpc_suffix_array_tpu_torch.kernels import refine_round as krr
from hpc_suffix_array_tpu_torch.kernels.refine_round import (
    round_gather, round_gather_bytes, round_gather_reference, round_split,
    round_split_bytes, round_split_reference)
from hpc_suffix_array_tpu_torch.utils.profiling import record

# (bits, spw) of the two cells' refinement words: english's 225 symbols
# and dna's 16, reserved-0.
PACKINGS = {"english": (8, 3), "dna": (5, 6)}


def _syms(word: int, spw: int, bits: int) -> list[int]:
    mask = (1 << bits) - 1
    return [(word >> bits * (spw - 1 - k)) & mask for k in range(spw)]


def _pack(codes: np.ndarray, spw: int, bits: int) -> np.ndarray:
    """int32 words of (m, spw) codes, first symbol highest."""
    acc = np.zeros(codes.shape[0], np.int64)
    for k in range(spw):
        acc = (acc << bits) | codes[:, k]
    return acc.astype(np.int32)


# --- the gather ---------------------------------------------------------------

def _gather_case(name):
    """(text codes, pk2, idx, d, spw, bits) of a named case."""
    packing = "dna" if name.startswith("dna") else "english"
    bits, spw = PACKINGS[packing]
    rng = np.random.default_rng(sum(map(ord, name)))
    n = {"one-row": 40}.get(name, 700)
    codes = rng.integers(1, min(1 << bits, 30), n).astype(np.int64)
    text = torch.from_numpy(codes.astype(np.uint8))
    # Codes map to themselves; the largest, 2^bits - 1, sets the packing.
    remap = (np.arange(256) % (1 << bits)).astype(np.int32)
    pk2 = trf.pair_table(text, remap)
    if name == "one-row":
        idx, d = np.array([n - 3], np.int32), 2 * spw
    else:
        # Positions near the end too: windows past n read the pad row.
        idx = rng.permutation(n)[:300].astype(np.int32)
        idx[:5] = [n - 1, n - 2, 0, n - spw, n - 2 * spw]
        d = 4 * spw if name.endswith("deep") else spw
    return codes, pk2, torch.from_numpy(idx), d, spw, bits


GATHER_CASES = ["english", "english-deep", "dna", "dna-deep", "one-row"]


@pytest.mark.parametrize("name", GATHER_CASES)
def test_gather_reference_matches_text_symbols(name):
    codes, pk2, idx, d, spw, bits = _gather_case(name)
    n = codes.shape[0]
    w0, w1 = round_gather_reference(idx, pk2, d)
    assert w0.dtype == w1.dtype == torch.int32
    past = 0
    for j, i in enumerate(idx.tolist()):
        start = min(i + d, n)
        past += start == n
        want = [int(codes[p]) if p < n else 0
                for p in range(start, start + 2 * spw)]
        got = (_syms(int(w0[j]), spw, bits) + _syms(int(w1[j]), spw, bits))
        assert got == want, j
    if name != "one-row":
        assert past > 0          # some window starts at n: the pad row


# --- the split ----------------------------------------------------------------

def _split_case(name):
    """(seg, w0, w1, patch, d, spw, bits) of a named case, rows sorted by
    (seg, w0, w1)."""
    packing = "dna" if name.startswith("dna") else "english"
    bits, spw = PACKINGS[packing]
    rng = np.random.default_rng(sum(map(ord, name)))
    m = 400
    if name == "one-row":
        m = 1
    # Windows from a pool of 40, half of which share word 0 with another:
    # rows tie, and split in either word.
    pool = rng.integers(0, 3, (40, 2 * spw))
    pool[20:, :spw] = pool[:20, :spw]
    codes = pool[rng.integers(0, 40, m)]
    if name.endswith("top"):
        codes[:, 0] = np.where(rng.random(m) < 0.5, (1 << bits) - 1,
                               codes[:, 0])
    w0, w1 = _pack(codes[:, :spw], spw, bits), _pack(codes[:, spw:], spw, bits)
    seg = np.sort(rng.integers(0, max(1, m // 12), m)).astype(np.int32)
    if name == "all-heads":
        seg = np.arange(m, dtype=np.int32)
    if name == "no-new-head":
        w0, w1 = w0[seg], w1[seg]                   # equal inside a segment
    order = np.lexsort((w1, w0, seg))
    seg, w0, w1 = seg[order], w0[order], w1[order]
    # Ordinals restarted at 0, as the rounds give them.
    seg = (np.cumsum(np.r_[True, seg[1:] != seg[:-1]]) - 1).astype(np.int32)
    patch = np.where(rng.random(m) < 0.3, rng.integers(0, 50, m),
                     -1).astype(np.int32)
    return seg, w0, w1, patch, 3 * spw, spw, bits


SPLIT_CASES = ["english", "english-top", "dna", "dna-top", "one-row",
               "all-heads", "no-new-head"]


def _split_oracle(seg, w0, w1, patch, d, spw, bits):
    """Row by row on Python ints: (ordinals, patch, tied)."""
    m = len(seg)
    out_patch = [int(p) for p in patch]
    heads = []
    for j in range(m):
        if j == 0:
            heads.append(True)
            continue
        parent = seg[j] != seg[j - 1]
        a = _syms(int(w0[j - 1]), spw, bits) + _syms(int(w1[j - 1]), spw,
                                                     bits)
        b = _syms(int(w0[j]), spw, bits) + _syms(int(w1[j]), spw, bits)
        first = next((k for k in range(2 * spw) if a[k] != b[k]), None)
        heads.append(bool(parent) or first is not None)
        if not parent and first is not None:
            out_patch[j] = d + first
    ordinals = [sum(heads[:j + 1]) - 1 for j in range(m)]
    return ordinals, out_patch, m - sum(heads)


def _tensors(case, device="cpu"):
    seg, w0, w1, patch, d, spw, bits = case
    to = lambda a: torch.as_tensor(np.asarray(a, np.int32)).to(device)
    return to(seg), to(w0), to(w1), to(patch), d, spw, bits


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_reference_matches_row_oracle(name):
    case = _split_case(name)
    ordinals, patch, tied = _split_oracle(*case)
    s_seg, s0, s1, p, d, spw, bits = _tensors(case)
    got_seg, got_patch, got_tied = round_split_reference(s_seg, s0, s1, p, d,
                                                         spw, bits)
    assert got_seg.data_ptr() == s_seg.data_ptr()       # in place
    assert got_patch.data_ptr() == p.data_ptr()
    assert got_seg.dtype == got_patch.dtype == torch.int32
    assert got_seg.tolist() == ordinals
    assert got_patch.tolist() == patch
    assert got_tied.dtype == torch.int64 and int(got_tied) == tied


def test_split_cases_cover_the_edges():
    """Heads everywhere, no new head, new heads in word 0 and in word 1,
    and the top code in a first symbol."""
    got = {name: _split_oracle(*_split_case(name)) for name in SPLIT_CASES}
    assert got["all-heads"][2] == 0 and got["one-row"][2] == 0
    for name in ("english", "dna", "english-top", "dna-top"):
        assert got[name][2] > 0
    case = _split_case("no-new-head")
    ordinals, patch, tied = got["no-new-head"]
    assert patch == case[3].tolist()
    assert ordinals == case[0].tolist() and tied == 400 - (case[0][-1] + 1)
    seg, w0, w1, patch0, d, spw, bits = _split_case("dna")
    new = [j for j in range(1, len(seg)) if seg[j] == seg[j - 1]
           and (w0[j], w1[j]) != (w0[j - 1], w1[j - 1])]
    assert any(w0[j] != w0[j - 1] for j in new)
    assert any(w0[j] == w0[j - 1] for j in new)
    top = _split_case("dna-top")
    assert (top[1] >> (bits * (spw - 1)) == (1 << bits) - 1).any()


# --- the dispatchers on the CPU -----------------------------------------------

def test_dispatchers_run_the_references_on_cpu(monkeypatch):
    calls = []

    def spy(real):
        def wrapped(*args):
            calls.append(real.__name__)
            return real(*args)
        return wrapped

    def no_kernel(*args):
        raise AssertionError("a kernel's launcher ran on the CPU")

    for name in ("round_gather_reference", "round_split_reference"):
        monkeypatch.setattr(krr, name, spy(getattr(krr, name)))
    monkeypatch.setattr(krr, "_launch_gather", no_kernel)
    monkeypatch.setattr(krr, "_launch_split", no_kernel)
    before = launch_counts()
    codes, pk2, idx, d, spw, bits = _gather_case("english")
    w0, w1 = round_gather(idx, pk2, d)
    want = round_gather_reference(idx, pk2, d)
    assert torch.equal(w0, want[0]) and torch.equal(w1, want[1])
    case = _split_case("english")
    got = round_split(*_tensors(case))
    ordinals, patch, tied = _split_oracle(*case)
    assert got[0].tolist() == ordinals and got[1].tolist() == patch
    assert int(got[2]) == tied
    assert calls == ["round_gather_reference", "round_split_reference"]
    assert launch_counts() == before


def test_refine_round_bytes_equal_the_formula_on_the_cpu():
    codes, pk2, idx, d, spw, bits = _gather_case("dna")
    m = idx.shape[0]
    with record("t", own=True) as rec:
        round_gather(idx, pk2, d)
    assert rec.counters == {"refine_round_bytes": round_gather_bytes(m)}
    assert round_gather_bytes(m) == m * (4 + 8 + 8)
    case = _tensors(_split_case("dna"))
    m = case[0].shape[0]
    with record("t", own=True) as rec:
        round_split(*case)
    assert rec.counters == {"refine_round_bytes": round_split_bytes(m)}
    assert round_split_bytes(m) == m * (12 + 8 + 4)


def _bad_gather(change):
    codes, pk2, idx, d, spw, bits = _gather_case("english")
    if change == "int64_idx":
        idx = idx.long()
    elif change == "empty":
        idx = idx[:0]
    elif change == "pk2_shape":
        pk2 = pk2[:, :1]
    elif change == "pk2_dtype":
        pk2 = pk2.long()
    elif change == "negative_d":
        d = -1
    return idx, pk2, d


@pytest.mark.parametrize("change,err", [
    ("int64_idx", TypeError), ("empty", ValueError), ("pk2_shape", TypeError),
    ("pk2_dtype", TypeError), ("negative_d", ValueError)])
def test_round_gather_rejects_bad_arguments(change, err):
    args = _bad_gather(change)
    for fn in (round_gather, round_gather_reference):
        with pytest.raises(err):
            fn(*args)


def _bad_split(change):
    s_seg, s0, s1, patch, d, spw, bits = _tensors(_split_case("english"))
    if change == "short_word":
        s1 = s1[:-1]
    elif change == "int64_seg":
        s_seg = s_seg.long()
    elif change == "empty":
        s_seg, s0, s1, patch = s_seg[:0], s0[:0], s1[:0], patch[:0]
    elif change == "wide_packing":
        bits = 8
        spw = 4
    elif change == "negative_d":
        d = -3
    elif change == "two_d_patch":
        patch = patch.view(-1, 1)
    return s_seg, s0, s1, patch, d, spw, bits


@pytest.mark.parametrize("change,err", [
    ("short_word", TypeError), ("int64_seg", TypeError), ("empty", ValueError),
    ("wide_packing", ValueError), ("negative_d", ValueError),
    ("two_d_patch", TypeError)])
def test_round_split_rejects_bad_arguments(change, err):
    args = _bad_split(change)
    for fn in (round_split, round_split_reference):
        with pytest.raises(err):
            fn(*args)


def test_no_fallback_for_other_devices():
    """Only CPU tensors take the plain versions; a device that is
    neither CPU nor CUDA raises instead of computing somewhere else, and
    counts nothing."""
    col = torch.zeros(8, dtype=torch.int32, device="meta")
    pk2 = torch.zeros((9, 2), dtype=torch.int32, device="meta")
    before = launch_counts()
    with record("t", own=True) as rec:
        with pytest.raises(ValueError, match="unsupported device"):
            round_gather(col, pk2, 3)
        with pytest.raises(ValueError, match="unsupported device"):
            round_split(col, col.clone(), col.clone(), col.clone(), 3, 5, 6)
    assert rec.counters == {} and launch_counts() == before


def test_columns_on_two_devices_are_rejected():
    s_seg, s0, s1, patch, d, spw, bits = _tensors(_split_case("english"))
    with pytest.raises(TypeError):
        round_split(s_seg, s0.to("meta"), s1, patch, d, spw, bits)


# --- on the card --------------------------------------------------------------

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")


def _card_split_inputs(m: int, seed: int, spw: int, bits: int):
    """m rows on the card: ordinals sorted over about m / 8 segments,
    words of 2-symbol alphabets, a patch of -1 and small values."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    seg = torch.randint(0, max(m // 8, 1), (m,), generator=g, device="cuda",
                        dtype=torch.int32).sort().values
    mask = sum(1 << (bits * k) for k in range(spw))    # symbols 0 or 1
    w = [torch.randint(0, 1 << 30, (m,), generator=g, device="cuda",
                       dtype=torch.int32) & mask for _ in range(2)]
    patch = torch.where(torch.rand(m, generator=g, device="cuda") < 0.3,
                        torch.randint(0, 99, (m,), generator=g, device="cuda",
                                      dtype=torch.int32), -1).to(torch.int32)
    return seg, w[0], w[1], patch


def _card_gather_inputs(m: int, seed: int):
    """A pk2 of m + 100 rows and m positions, some of whose windows pass
    the end."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = m + 99
    pk2 = torch.randint(0, 1 << 30, (n + 1, 2), generator=g, device="cuda",
                        dtype=torch.int32)
    pk2[n] = 0
    idx = torch.randint(0, n, (m,), generator=g, device="cuda",
                        dtype=torch.int32)
    return idx, pk2


def _same_split(args):
    seg, w0, w1, patch, d, spw, bits = args
    got = round_split(seg.clone(), w0, w1, patch.clone(), d, spw, bits)
    want = round_split_reference(seg.clone(), w0, w1, patch.clone(), d, spw,
                                 bits)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[2].dtype == torch.int64 and int(got[2]) == int(want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_kernel_matches_oracle_on_card(name):
    _need_cuda()
    case = _split_case(name)
    args = _tensors(case, "cuda")
    _same_split(args)
    ordinals, patch, tied = _split_oracle(*case)
    got = round_split(*_tensors(case, "cuda"))
    assert got[0].tolist() == ordinals and got[1].tolist() == patch
    assert int(got[2]) == tied


@pytest.mark.cuda
@pytest.mark.parametrize("name", GATHER_CASES)
def test_gather_kernel_matches_reference_on_card(name):
    _need_cuda()
    codes, pk2, idx, d, spw, bits = _gather_case(name)
    got = round_gather(idx.cuda(), pk2.cuda(), d)
    want = round_gather_reference(idx, pk2, d)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 31, 4095, 4096, 4097, 3 * 4096 + 5,
                               (1 << 20) + 17, 1 << 24])
@pytest.mark.parametrize("packing", sorted(PACKINGS))
def test_kernels_sizes_on_card(m, packing):
    _need_cuda()
    bits, spw = PACKINGS[packing]
    idx, pk2 = _card_gather_inputs(m, m + bits)
    for d in (spw, 50 * spw):
        got = round_gather(idx, pk2, d)
        want = round_gather_reference(idx, pk2, d)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _same_split((*_card_split_inputs(m, m + spw, spw, bits), 7 * spw, spw,
                 bits))
    del idx, pk2
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, 0, 0, 0), (1, 1, 1, 1),
                                     (2, 2, 2, 2), (3, 3, 3, 3),
                                     (5, 5, 5, 5), (1, 2, 3, 0),
                                     (0, 0, 0, 1), (4, 4, 0, 4)])
def test_kernels_on_slices_on_card(offsets):
    """Columns as slices at row offsets: one misalignment everywhere
    takes the wide path, mixed ones the row-by-row path; rows outside
    the slices stay as they were."""
    _need_cuda()
    m = 10_000 + 3
    bits, spw = PACKINGS["dna"]
    cols = _card_split_inputs(m, sum(offsets), spw, bits)
    slabs = [torch.full((m + 16,), -9, dtype=torch.int32, device="cuda")
             for _ in cols]
    for s, c, a in zip(slabs, cols, offsets):
        s[a:a + m] = c
    views = [s[a:a + m] for s, a in zip(slabs, offsets)]
    want = round_split_reference(*[c.clone() for c in cols], 4 * spw, spw,
                                 bits)
    got = round_split(*views, 4 * spw, spw, bits)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[2]) == int(want[2])
    for s, a in zip(slabs, offsets):
        assert (s[:a] == -9).all() and (s[a + m:] == -9).all()

    idx, pk2 = _card_gather_inputs(m, 5)
    a_idx = offsets[0]
    slab = torch.zeros(m + 16, dtype=torch.int32, device="cuda")
    slab[a_idx:a_idx + m] = idx
    got = round_gather(slab[a_idx:a_idx + m], pk2[offsets[3]:], 2 * spw)
    want = round_gather_reference(idx, pk2[offsets[3]:], 2 * spw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_kernels_count_one_launch_each_on_card():
    _need_cuda()
    codes, pk2, idx, d, spw, bits = _gather_case("english")
    args = _tensors(_split_case("english"), "cuda")
    before = launch_counts()
    with record("t", own=True) as rec:
        round_gather(idx.cuda(), pk2.cuda(), d)
        round_split(*args)
    torch.cuda.synchronize()
    after = launch_counts()
    assert after["refine_gather"] == before["refine_gather"] + 1
    assert after["refine_split"] == before["refine_split"] + 1
    m = args[0].shape[0]
    assert rec.counters == {
        "launches: refine_gather": 1, "launches: refine_split": 1,
        "refine_round_bytes": round_gather_bytes(idx.shape[0])
        + round_split_bytes(m)}


@pytest.mark.cuda
def test_refinement_with_kernels_equals_reference_on_card(monkeypatch):
    """A whole carried-keys build of a words text whose ties refine: the
    same SA and LCP with the kernels as with the plain round on the card
    (and as SA-IS/Kasai), and one gather and one split a word round."""
    _need_cuda()
    for k, v in {"SA_BIG_THRESHOLD": 1 << 14, "SA_LCP_BIG_MIN": 1 << 14,
                 "SA_HOST_RESIDUE_MAX": 8}.items():
        monkeypatch.setenv(k, str(v))
    text = generate_words_text(1 << 20, seed=3)
    info: dict = {}
    sa, lcp = tsa.build_sa_lcp(text, device="cuda", info=info)
    counters = info["counters"]
    assert counters["refine_word_rounds"] > 0
    assert counters["launches: refine_gather"] == counters[
        "refine_word_rounds"] == counters["launches: refine_split"]
    monkeypatch.setattr(trf, "round_gather", round_gather_reference)
    monkeypatch.setattr(trf, "round_split", round_split_reference)
    plain: dict = {}
    sa2, lcp2 = tsa.build_sa_lcp(text, device="cuda", info=plain)
    assert "launches: refine_gather" not in plain["counters"]
    assert torch.equal(sa, sa2) and torch.equal(lcp, lcp2)
    want = suffix_array_oracle(text)
    assert np.array_equal(sa.cpu().numpy(), want)
    assert np.array_equal(lcp.cpu().numpy(), lcp_oracle(text, want))
