"""Direct carried-keys suffix sort: SA (and LCP) from one key sort.

Counterpart of the direct half of ``hpc_suffix_array_tpu/core/bigsort.py``
(``prepare_direct``/``execute_direct`` and what they call):

  1. *Plan (host)*: the dense alphabet remap packs ``spw = 30 // bits``
     symbols per int32 word (``packing_from_sigma``; power-of-two
     alphabets take the denser ``minpad`` packing). Each suffix gets
     ``nw`` (2, or 3 for small alphabets whose 2-word residue would
     overflow) words covering its first ``nw*spw`` symbols.
  2. *Keys (device)*: word w is the pack kernel (K1, ``kernels/pack.py``)
     at word offset ``w*spw``; minpad feeds it the table
     ``max(remap - 1, 0)``.
  3. *Sort (device)*: ``kernels/radix.py::radix_sort_words``, the
     hand-written onesweep LSD radix sort, with the positions as
     payload. Chain mode needs descending positions inside ties: the
     keys and positions are fed in reverse, so the stable sort keeps
     ties in descending position order. That costs one copy of each
     column; a fourth key ``n - idx`` (the JAX package's choice for its
     unstable sort) would cost four more radix passes.
  4. *Post-sort pass (device, plain PyTorch)*: tie flags, the chain delta
     (``dmax``, ``dmin``, ``delta_ok``) and, with ``want_lcp``, the LCP
     of adjacent keys from xor and the highest set bit.
  5. *Chain mode / residue / refinement*: globally periodic texts
     resolve their ties by the chain rule after a period check
     (``_period_mismatches``); otherwise the window-tied pairs are
     extracted and ordered on the host (``_resolve_residue_host``, copied
     from the JAX package) within its cap, and past it by the device
     tie refinement (``core/refine.py``), whose remainder the same host
     pass closes.

Not ported here: the MSD builder, ``codes_from_bytes``/``byte_ranges``
(workarounds for XLA's per-element gather cost; the pack kernel reads
the remap from shared memory) and ``bucket_size`` padding (no
``PAD_KEY`` rows exist).
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.core.suffix_array import (
    alphabet_remap, alphabet_remap_dev, as_byte_array, device_text)
from hpc_suffix_array_tpu_torch.kernels.pack import pack_ranks
from hpc_suffix_array_tpu_torch.kernels.radix import radix_sort_words

RESIDUE_SLOTS = 1 << 15          # extracted tie members (the JAX cap)
RESIDUE_WIN = 64     # bytes compared vectorized before the exact fallback
# Repeat-estimate threshold for "route a mid-size text to the carried
# keys machinery": 3 words x max spw-per-word bound (~16).
DEEP_REPEAT_EST = 3 * 16


def packing_from_sigma(sigma: int) -> tuple[int, int, bool]:
    """(bits, spw, minpad) for the carried-key paths.

    Reserved-0 packing maps real symbols to 1..sigma and past-the-end to
    0, so a suffix that is a prefix of another orders first inside the
    window. ``minpad`` packing uses codes 0..sigma-1 and pads with 0, the
    minimum symbol: it never misorders strictly (a padded comparison
    either still wins or ties, and ties are resolved with true lengths),
    and it is chosen when it packs more symbols per word (powers of two:
    DNA 15 per word instead of 10). Its key-derived LCP then needs the
    shorter-suffix clamp (``_clamp_lcp``)."""
    k = max(int(sigma), 1)
    bits_res = max(1, k.bit_length())
    if k >= 2:
        bits_mp = max(1, (k - 1).bit_length())
        if 30 // bits_mp > 30 // bits_res:
            return bits_mp, 30 // bits_mp, True
    return bits_res, 30 // bits_res, False


def packing_mode(remap: np.ndarray) -> tuple[int, int, bool]:
    """(bits, spw, minpad) from a dense alphabet remap table."""
    return packing_from_sigma(int(remap.max()))


def estimate_repeat_len(arr: np.ndarray, sample: int = 1 << 16,
                        probe_depth: int = 4096, seed: int = 0x11
                        ) -> int:
    """Cheap host-side estimate of the text's longest repeat (bytes).

    Samples positions, finds 8-byte-window collisions among them, and
    extends a few hundred colliding pairs by direct comparison. Periodic
    texts score near the probe depth; random text scores about log n."""
    n = len(arr)
    if n < 64:
        return 0
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n - 9, min(sample, n))
    win = np.zeros(len(pos), np.uint64)
    for j in range(8):
        win = (win << np.uint64(8)) | arr[pos + j].astype(np.uint64)
    order = np.argsort(win, kind="stable")
    ws, ps = win[order], pos[order]
    coll = np.flatnonzero((ws[1:] == ws[:-1]) & (ps[1:] != ps[:-1]))[:256]
    best = 8 if len(coll) else 0
    for c in coll:
        a, b = int(ps[c]), int(ps[c + 1])
        lim = min(probe_depth, n - max(a, b))
        wa, wb = arr[a:a + lim], arr[b:b + lim]
        neq = np.flatnonzero(wa != wb)
        best = max(best, int(neq[0]) if len(neq) else lim)
    return best


def carried_depth_syms(sigma: int) -> int:
    """Symbols resolved by the carried keys (2 words)."""
    return 2 * packing_from_sigma(sigma)[1]


def deep_repeat_class(est_repeat: int) -> bool:
    """Mid-size routing gate: repeats beyond every one-pass window."""
    return est_repeat > DEEP_REPEAT_EST


def chain_plausible(est_repeat: int, n: int) -> bool:
    """Is the text plausibly globally periodic (chain-mode material)?

    On a globally periodic text the repeat estimate saturates near its
    4096-byte probe depth; texts with merely long repeated phrases score
    well below it (``SA_CHAIN_EST_MIN``, default 3072, capped at n/4)."""
    thresh = min(int(os.environ.get("SA_CHAIN_EST_MIN", 3072)),
                 max(n // 4, 1))
    return est_repeat >= thresh


def residue_feasible_sigma(sigma: int, n: int, cap: float,
                           est_repeat: int, words: int = 2,
                           spw: int | None = None) -> bool:
    """``residue_feasible`` arithmetic from precomputed inputs."""
    sigma = max(int(sigma), 2)
    if spw is None:
        spw = packing_from_sigma(sigma)[1]
    log_pred = 2 * math.log(n) - words * spw * math.log(sigma)
    if log_pred < math.log(max(cap, 2.0)):
        return True
    return est_repeat > words * spw      # periodic: chain rule, no cap


def residue_feasible(arr: np.ndarray, n: int, cap: float,
                     est_repeat: int | None = None,
                     words: int = 2, spw: int | None = None,
                     sigma: int | None = None) -> bool:
    """Expected window-tied residue of ``words`` carried words fits
    ``cap``, or the text looks globally periodic (the chain rule has no
    cap). Assumes uniform text: skewed texts that slip past raise
    NotImplementedError downstream and the caller falls back. The repeat
    scan runs only when the cap-only test fails."""
    if sigma is None:
        remap, _, _ = alphabet_remap(arr)
        sigma = int(remap.max())
    if residue_feasible_sigma(sigma, n, cap, 0, words, spw):
        return True
    if est_repeat is None:
        est_repeat = estimate_repeat_len(arr)
    return residue_feasible_sigma(sigma, n, cap, est_repeat, words, spw)


def direct_feasible(arr: np.ndarray, n: int,
                    est_repeat: int | None = None,
                    sigma: int | None = None) -> bool:
    """Host-side gate for the direct path: n within ``SA_DIRECT_MAX``
    and the expected window-tied residue within the extraction cap, with
    two or three words. The JAX package compares its padded sort length
    (``bucket_size(n)``) with the cap; the port sorts n elements and
    compares n, which is the same test at the default cap."""
    if n > int(os.environ.get("SA_DIRECT_MAX", 1 << 28)):
        return False
    return (residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                             sigma=sigma)
            or residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                                words=3, sigma=sigma))


def prefer_direct(arr: np.ndarray, n: int,
                  est_repeat: int | None = None,
                  sigma: int | None = None) -> bool:
    """The JAX package's choice between its direct and MSD builders:
    direct when feasible up to ``SA_DIRECT_CROSS`` (2^27, a crossover
    measured on a TPU v5e), and above it only for chain-class texts.
    The port has no MSD builder, so its routers gate on
    ``direct_feasible`` and do not call this."""
    if not direct_feasible(arr, n, est_repeat, sigma=sigma):
        return False
    if n <= int(os.environ.get("SA_DIRECT_CROSS", 1 << 27)):
        return True
    if est_repeat is None:
        est_repeat = estimate_repeat_len(arr)
    return chain_plausible(est_repeat, n)


# --- device pieces --------------------------------------------------------

def direct_keys(text: torch.Tensor, remap: np.ndarray, bits: int, spw: int,
                nw: int, minpad: bool) -> list[torch.Tensor]:
    """The ``nw`` carried key words (int32[n] each) of uint8 ``text``:
    word w packs the spw codes from i + w*spw, 0 past n (the JAX
    package's ``_direct_keys`` without its PAD_KEY rows)."""
    table = np.maximum(remap - 1, 0) if minpad else remap
    table_t = torch.as_tensor(table.astype(np.int32)).to(text.device)
    n = text.shape[0]
    return [pack_ranks(text, table_t, bits, spw, n, offset=w * spw)
            for w in range(nw)]


def _high_bit(x: torch.Tensor) -> torch.Tensor:
    """Index of the highest set bit of each nonzero int32 (31 for a
    negative value), by a 5-step integer binary search. Exact for every
    int32; float log2 would round 2^k - 1 up."""
    pos = torch.zeros_like(x)
    v = x & 0x7FFFFFFF
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        v = torch.where(big, v >> s, v)
        pos += big.to(torch.int32) * s
    return torch.where(x < 0, 31, pos)


def post_sort(words, s_idx: torch.Tensor, n: int, spw: int, bits: int,
              desc_idx: bool, want_lcp: bool):
    """The pass after the sort: the JAX package's ``_bucket_sort`` (as
    one whole-text bucket) and ``_direct_sort3`` in one, over 2 or 3
    sorted key words.

    Returns (tie bool[n], stats int64[3] = (tie count, dmax, delta_ok),
    lcp int32[n] or None). ``tie[j]``: row j's key words equal row
    j-1's. ``delta`` is the index step along ties (descending in chain
    mode); ``delta_ok`` says every tie has the same step >= 1. The LCP
    of a non-tied pair is the first differing symbol of the keys, from
    the highest set bit of their xor; row 0 compares with a -1 sentinel,
    whose bit 31 puts the symbol below 0, clamped to 0. In chain mode a
    tied pair's LCP is ``n - prev_idx`` (consecutive chain members)."""
    dev = s_idx.device
    big = 1 << 30
    tie = torch.zeros(n, dtype=torch.bool, device=dev)
    if n > 1:
        eq = words[0][1:] == words[0][:-1]
        for w in words[1:]:
            eq &= w[1:] == w[:-1]
        tie[1:] = eq
    prev_idx = torch.cat([s_idx[:1], s_idx[:-1]])
    delta = (prev_idx - s_idx) if desc_idx else (s_idx - prev_idx)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    dmax = torch.where(tie, delta, zero).max()
    dmin = torch.where(tie, delta, torch.full_like(zero, big)).min()
    any_tie = tie.any()
    delta_ok = ~any_tie | ((dmin == dmax) & (dmax >= 1))
    stats = torch.stack([tie.sum(), dmax.long(), delta_ok.long()])
    if not want_lcp:
        return tie, stats, None
    nw = len(words)
    lcp = torch.full((n,), nw * spw, dtype=torch.int32, device=dev)
    # Word by word from the last: the first differing word wins.
    for w in reversed(range(nw)):
        prev = torch.cat([torch.full((1,), -1, dtype=torch.int32,
                                     device=dev), words[w][:-1]])
        x = prev ^ words[w]
        off = (w + 1) * spw - 1 - torch.div(_high_bit(x), bits,
                                            rounding_mode="floor")
        lcp = torch.where(x != 0, off.to(torch.int32), lcp)
    lcp.clamp_(min=0)
    if desc_idx:
        lcp = torch.where(tie, n - prev_idx, lcp)
    return tie, stats, lcp


def _extract_ties(tie: torch.Tensor, sa: torch.Tensor):
    """(slots int64[P], idx int32[P]) of every tie-group member, slots
    ascending. A group contributes all its members: the flag marks the
    later element of each tied pair, heads join via their successor."""
    member = tie.clone()
    member[:-1] |= tie[1:]
    slots = torch.nonzero(member).view(-1)
    return slots, sa[slots]


def _apply_patch(sa: torch.Tensor, slots: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """Write ``vals`` into ``sa`` at ``slots``, in place, dropping pad
    slots (-1). They are never clamped to slot 0: with a real patch
    there too, two writes to one index have no defined order (the
    ``_apply_patch`` fault the JAX package fixed)."""
    keep = slots >= 0
    sa[slots[keep]] = vals[keep].to(sa.dtype)
    return sa


def _clamp_lcp(sa: torch.Tensor, lcp: torch.Tensor, n: int) -> torch.Tensor:
    """Final shorter-suffix clamp: lcp[j] <= n - max(sa[j-1], sa[j]).

    Under minpad packing a suffix ending inside the window continues as
    min-symbol pads, so the key-derived value can overshoot; the clamp
    runs over the final (post-residue) SA. Row 0 pairs with itself."""
    prev = torch.cat([sa[:1], sa[:-1]])
    return torch.minimum(lcp, n - torch.maximum(prev, sa))


def _period_mismatches(text: torch.Tensor, d: int, n: int) -> int:
    """#positions t in [0, n-d) with text[t] != text[t+d]."""
    if d >= n:
        return 0
    return int((text[:n - d] != text[d:n]).sum())


# --- host residue (numpy, as in the JAX package) ---------------------------

def _suffix_less(arr: np.ndarray, a: int, b: int, n: int,
                 step: int = 4096) -> bool:
    """Exact suffix comparison by bounded windows (host)."""
    off = 0
    while True:
        la, lb = n - a - off, n - b - off
        L = min(la, lb, step)
        if L <= 0:
            return la < lb          # equal through the shorter's end
        wa = arr[a + off:a + off + L]
        wb = arr[b + off:b + off + L]
        neq = np.flatnonzero(wa != wb)
        if len(neq):
            t = int(neq[0])
            return bool(wa[t] < wb[t])
        if L < step:
            return la < lb
        off += L


def _suffix_lcp(arr: np.ndarray, a: int, b: int, n: int,
                step: int = 4096) -> int:
    """Exact LCP of suffixes a and b by bounded windows (host)."""
    off = 0
    while True:
        L = min(n - a - off, n - b - off, step)
        if L <= 0:
            return n - max(a, b)        # one is a prefix of the other
        neq = np.flatnonzero(arr[a + off:a + off + L]
                             != arr[b + off:b + off + L])
        if len(neq):
            return off + int(neq[0])
        if L < step:
            return n - max(a, b)
        off += L


class _ArrView:
    """Whole-text accessor for residue resolution.

    fetch(idxs, K) -> int16[len(idxs), K] suffix windows, -1 past the
    end (a shorter suffix that is a prefix orders first);
    suffix_less(a, b) / suffix_lcp(a, b): exact order / lcp for the rare
    pairs equal through the whole RESIDUE_WIN window."""

    def __init__(self, arr: np.ndarray, n: int):
        self.arr, self.n = arr, n

    def fetch(self, idxs: np.ndarray, K: int) -> np.ndarray:
        pos = idxs.astype(np.int64)[:, None] + np.arange(K, dtype=np.int64)
        return np.where(pos < self.n,
                        self.arr[np.minimum(pos, self.n - 1)
                                 ].astype(np.int16),
                        np.int16(-1))

    def suffix_less(self, a: int, b: int) -> bool:
        return _suffix_less(self.arr, a, b, self.n)

    def suffix_lcp(self, a: int, b: int) -> int:
        return _suffix_lcp(self.arr, a, b, self.n)


def _resolve_residue_host(arr, slots: np.ndarray,
                          idxs: np.ndarray, n: int, want_lcp: bool = False):
    """Exact order for the tied elements (host comparison).

    Groups are runs of consecutive slots; order within each group = full
    suffix order. Returns (ascending slots, idx aligned to them,
    lcp-patch slots, lcp-patch values). The lcp patches cover every
    group-internal adjacent pair; the key-derived lcp at a group's edge
    is invariant under the reorder (exact under reserved-0 packing; under
    minpad the final ``_clamp_lcp`` makes it exact, so that clamp must
    run after this patch).

    Vectorized: one RESIDUE_WIN-byte window per member, np.lexsort within
    groups, and the exact comparison only for pairs equal through the
    whole window."""
    view = _ArrView(arr, n)
    order = np.argsort(slots, kind="stable")
    slots, idxs = slots[order], idxs[order]
    P = len(slots)
    if P == 0:
        return slots, idxs, np.zeros(0, np.int64), np.zeros(0, np.int32)
    gid = np.cumsum(np.r_[np.int64(0),
                          (np.diff(slots) != 1).astype(np.int64)])
    K = RESIDUE_WIN
    win = view.fetch(idxs, K)
    valid = win >= 0
    # lexsort: last key is primary -> (gid, win[:,0], ..., win[:,K-1]).
    o2 = np.lexsort([win[:, k] for k in range(K - 1, -1, -1)] + [gid])
    out = idxs[o2]
    win_s, valid_s, gid_s = win[o2], valid[o2], gid[o2]
    same_g = gid_s[1:] == gid_s[:-1]
    eq_win = (win_s[1:] == win_s[:-1]).all(axis=1)
    # Pairs equal through the full window with both suffixes extending
    # past it are undecided by the lexsort: fix their runs exactly.
    undecided = same_g & eq_win & valid_s[1:, K - 1] & valid_s[:-1, K - 1]
    if undecided.any():
        run_edges = np.flatnonzero(np.diff(
            np.r_[False, undecided, False].astype(np.int8)))
        for lo, hi in zip(run_edges[::2], run_edges[1::2]):
            seg = out[lo:hi + 1].tolist()      # undecided run + its tail
            seg.sort(key=functools.cmp_to_key(
                lambda a, b: -1 if view.suffix_less(a, b) else 1))
            out[lo:hi + 1] = seg
    if not want_lcp:
        return slots, out, np.zeros(0, np.int64), np.zeros(0, np.int32)
    # LCP for every group-internal adjacent pair of the final order.
    win = view.fetch(out, K)
    neq = win[1:] != win[:-1]
    has_mm = neq.any(axis=1)
    first_mm = np.argmax(neq, axis=1)
    # No mismatch in-window: either one suffix ended inside (lcp = its
    # length) or both extend (exact fallback below).
    shorter = np.minimum(n - out[1:].astype(np.int64),
                         n - out[:-1].astype(np.int64))
    lv = np.where(has_mm, first_mm, np.minimum(shorter, K)).astype(np.int64)
    internal = np.flatnonzero(same_g)
    lslots = slots[internal + 1].astype(np.int64)
    lvals = lv[internal]
    deep = internal[(~has_mm[internal]) & (shorter[internal] > K)]
    for j in deep:
        lvals[np.searchsorted(internal, j)] = view.suffix_lcp(
            int(out[j]), int(out[j + 1]))
    return slots, out, lslots, lvals.astype(np.int32)


def _apply_residue(sa, lcp, arr, patches, n: int, want_lcp: bool):
    """Resolve host residue groups and patch them into sa (and lcp).

    ``patches``: list of (slots int64[], idxs int32[]) per extraction.
    Returns (sa, lcp, n_patched)."""
    all_slots, all_vals = [], []
    lcp_slots, lcp_vals = [], []
    for slots, idxs in patches:
        if not len(slots):
            continue
        s_sorted, fixed, ls, lv = _resolve_residue_host(
            arr, slots, idxs, n, want_lcp=want_lcp)
        all_slots.append(s_sorted.astype(np.int64))
        all_vals.append(fixed)
        lcp_slots.append(ls)
        lcp_vals.append(lv)

    def _patch(target, slot_parts, val_parts):
        slots = np.concatenate(slot_parts)
        if not len(slots):
            return target
        dev = target.device
        return _apply_patch(
            target, torch.as_tensor(slots, dtype=torch.int64).to(dev),
            torch.as_tensor(np.concatenate(val_parts).astype(np.int32)
                            ).to(dev))

    n_patched = 0
    if all_slots:
        sa = _patch(sa, all_slots, all_vals)
        n_patched = int(sum(len(s) for s in all_slots))
    if want_lcp and lcp_slots:
        lcp = _patch(lcp, lcp_slots, lcp_vals)
    return sa, lcp, n_patched


# --- the builder ------------------------------------------------------------

def prepare_direct(text, *, device, text_dev=None, n_words: int | None = None,
                   remap: np.ndarray | None = None,
                   est_repeat: int | None = None) -> dict:
    """Plan the direct build and stage the text (untimed setup).

    ``text``: the host bytes (planning and the residue read them).
    ``text_dev``: optional uint8 copy of the same bytes on ``device``
    (at least n long), used instead of staging ``text``.
    ``n_words``: carried key words (default: 2, or 3 when the 2-word
    residue overflows the extraction cap and the 3-word one fits).
    ``remap``/``est_repeat``: planning products already computed for
    the same bytes."""
    arr = as_byte_array(text)
    n = int(arr.shape[0])
    if n < 8:
        raise ValueError("direct sort needs n >= 8; use build_suffix_array")
    t = device_text(arr, device, text_dev)
    if remap is None:
        remap, _, _ = alphabet_remap_dev(t)
    bits, spw, minpad = packing_mode(remap)
    if est_repeat is None:
        est_repeat = estimate_repeat_len(arr)
    sigma = int(remap.max())
    nw = n_words
    if nw is None:
        nw = 2
        if not residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                                sigma=sigma):
            if residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                                words=3, sigma=sigma):
                nw = 3
    return {"n": n, "bits": bits, "spw": spw, "nw": nw, "minpad": minpad,
            "remap": remap, "text_dev": t, "host_text": arr,
            "meta": {"est_repeat": est_repeat}}


def _sorted_keys(state: dict, chain_mode: bool):
    """(sorted words, sorted positions int32[n]) of the whole text."""
    t, n = state["text_dev"], state["n"]
    words = direct_keys(t, state["remap"], state["bits"], state["spw"],
                        state["nw"], state["minpad"])
    idx = torch.arange(n, dtype=torch.int32, device=t.device)
    if chain_mode:                      # stable sort of reversed input
        words = [w.flip(0) for w in words]
        idx = idx.flip(0)
    return radix_sort_words(words, idx, state["bits"] * state["spw"])


def execute_direct(state: dict, *, force_chain_mode: bool | None = None,
                   want_lcp: bool = False):
    """One sort of the whole text's carried keys; returns the SA (and the
    LCP with ``want_lcp``), int32[n] on the state's device.

    Chain mode (globally periodic texts, or forced) verifies a uniform
    tie delta that is a global period; a misprediction reruns ascending
    (``meta["rerun"]``: ``chain_to_ascending``), and an ascending run
    that ties over a quarter of a chain-plausible text reruns in chain
    mode (``ascending_to_chain``). Ascending ties go to the host residue
    within its cap; past it, or past the extraction cap, the device
    refinement (``core/refine.py``) orders them. Raises
    NotImplementedError where forced chain mode does not hold, and
    ``RefineOverflow`` (one) where refinement exceeds a cap."""
    n, spw, bits = state["n"], state["spw"], state["bits"]
    meta = state["meta"]
    chain_mode = force_chain_mode
    if chain_mode is None:
        chain_mode = chain_plausible(meta.get("est_repeat", 0), n)

    words, s_idx = _sorted_keys(state, chain_mode)
    tie, stats, lcp = post_sort(words, s_idx, n, spw, bits, chain_mode,
                                want_lcp)
    del words
    ties, d, dok = stats.tolist()

    def rerun(kind: str, force: bool):
        meta.setdefault("rerun", []).append(kind)
        return execute_direct(state, force_chain_mode=force,
                              want_lcp=want_lcp)

    if chain_mode:
        if ties:
            if not dok:
                if force_chain_mode is None:
                    del s_idx, tie, lcp
                    return rerun("chain_to_ascending", False)
                raise NotImplementedError(
                    "residual ties are not uniform arithmetic chains")
            if d:
                mm = _period_mismatches(state["text_dev"], d, n)
                if mm:
                    if force_chain_mode is None:
                        del s_idx, tie, lcp
                        return rerun("chain_to_ascending", False)
                    raise NotImplementedError(
                        f"chain delta {d} is not a global period "
                        f"({mm} mismatches)")
                meta["periods"] = [d]
    elif (ties > n // 4
          and chain_plausible(meta.get("est_repeat", 0), n)
          and "chain_to_ascending" not in meta.get("rerun", [])):
        del s_idx, tie, lcp
        return rerun("ascending_to_chain", True)

    patches = []
    refine = False
    # The JAX package's gate: the direct build is one whole-text bucket,
    # so the member cap applies to the flag count (members <= 2*flags +
    # groups); past it, or past the extraction cap, refine on the device.
    host_cap = int(os.environ.get("SA_HOST_RESIDUE_MAX", 1 << 20))
    if ties and not chain_mode:
        refine = ties * 2 > RESIDUE_SLOTS or ties > host_cap
        if not refine:
            slots, idxs = _extract_ties(tie, s_idx)
            refine = slots.shape[0] > RESIDUE_SLOTS
            if not refine:
                patches.append((slots.cpu().numpy(), idxs.cpu().numpy()))
    sa = s_idx
    if refine:
        from hpc_suffix_array_tpu_torch.core.refine import refine_ties

        sa, lcp = refine_ties(
            sa, tie, lcp, state["text_dev"], remap=state["remap"],
            spw_main=spw, nw=state["nw"], minpad=state["minpad"],
            host_text=state["host_text"], want_lcp=want_lcp, meta=meta)
        meta["n_patched"] = meta["refine_host_members"]
    del tie
    if patches:
        sa, lcp, n_patched = _apply_residue(
            sa, lcp, state["host_text"], patches, n, want_lcp)
        meta["n_patched"] = n_patched
    if want_lcp and state["minpad"]:
        # After the residue and refinement patches (see _clamp_lcp).
        lcp = _clamp_lcp(sa, lcp, n)
    meta["chain_mode"] = chain_mode
    return (sa, lcp) if want_lcp else sa


def build_suffix_array_direct(text, *, device, info: dict | None = None,
                              force_chain_mode: bool | None = None,
                              want_lcp: bool = False, **kw):
    """One-call direct build (``prepare_direct`` + ``execute_direct``).

    ``info``: optional dict that receives the build's ``rerun``,
    ``chain_mode``, ``n_patched``, ``periods`` and, where refinement
    ran, ``refine_members``, ``refine_rounds``, ``refine_pieces``,
    ``refine_host_members`` (as in the JAX package) and
    ``refine_phase_s``, plus ``n_words``."""
    state = prepare_direct(text, device=device, **kw)
    out = execute_direct(state, force_chain_mode=force_chain_mode,
                         want_lcp=want_lcp)
    if info is not None:
        info.update({k: v for k, v in state["meta"].items()
                     if k in ("rerun", "chain_mode", "n_patched",
                              "periods", "refine_members",
                              "refine_rounds", "refine_pieces",
                              "refine_host_members", "refine_phase_s")})
        info["n_words"] = state["nw"]
    return out
