"""Direct carried-keys suffix sort: SA (and LCP) from one key sort.

Counterpart of the direct half of ``hpc_suffix_array_tpu/core/bigsort.py``
(``prepare_direct``/``execute_direct`` and what they call):

  1. *Plan (host)*: the dense alphabet remap packs ``spw = 30 // bits``
     symbols per int32 word (``packing_from_sigma``; power-of-two
     alphabets take the denser ``minpad`` packing). Each suffix gets
     ``nw`` (2, or 3 for small alphabets whose 2-word residue would
     overflow) words covering its first ``nw*spw`` symbols.
  2. *Keys (device)*: one launch of the pack kernel (K1,
     ``kernels/pack.py::pack_words``) writes all ``nw`` words, word w
     folding the symbols from ``w*spw``; minpad feeds it the table
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

The MSD bucket builder (``prepare_big``/``execute_big``, the JAX
package's carried-keys bucket sort for texts past the direct route)
serves the sizes one whole-text sort cannot hold:

  1. *Plan (host)*: the same packing; bucket edges are quantiles of
     sampled k0 words (``sample_edges``; (k0, k1) pairs when k0 alone
     is too skewed), at most ``MAX_RADIX`` buckets.
  2. *Count (device)*: per chunk of ``m`` positions, K1 packs k0 (and
     k1 for pair edges), ``torch.searchsorted`` gives each position's
     bucket id and ``torch.bincount`` the chunk's bucket counts; one host
     read of the (chunks, buckets) table.
  3. *Scatter (device)*: bucket b's region of the slabs starts at the
     count of all positions in buckets below b, which is also its final
     SA range. One ``onesweep_pass`` per chunk partitions (bid, k0, k1,
     idx) by the bucket id straight into those full-length slabs at the
     chunk's offsets, stable and in chunk order, so every region holds
     its positions ascending.
  4. *Buckets (device)*: each region is sorted in place by
     ``radix_sort_words`` and finished by ``post_sort``, row 0 against
     the previous bucket's last keys; chain mode reverses a region before
     its sort. The tie flags go to one bool[n], the LCP into the dead
     bucket-id slab; after the last bucket the idx slab is the SA.
  5. *Residue, chain mode, refinement*: as in the direct build, with
     the tie counts per bucket.

The JAX package's count-free layout (fill-fraction capacities, run
boundaries searched in each sorted chunk, the ``count_free_overflow``
rerun), its spill-forward W windows and slab gaps and its
``optimization_barrier`` fences worked around XLA's costs (no masked
in-place writes, no cheap scans) and are not ported: an exact count is
one K1 launch and a ``bincount`` per chunk here, and the onesweep pass
writes every run to its exact place.

``replan_edges`` refreshes a plan's edges between builds: k0-only plans
are re-sampled on the device (``_sample_k0_device``, a strided view of
the text), pair-edge plans on the host.

Not ported here: ``codes_from_bytes``/``byte_ranges`` (workarounds for
XLA's per-element gather cost; the pack kernel reads the remap from
shared memory, so the re-plan's device sampler needs no range-mappable
alphabet), the sampled fill fractions (``fill_frac``, which sized the
count-free layout) and ``bucket_size`` padding (no ``PAD_KEY`` rows
exist).
"""

from __future__ import annotations

import functools
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.core.suffix_array import (
    alphabet_remap, alphabet_remap_dev, as_byte_array, device_text)
from hpc_suffix_array_tpu_torch.kernels.pack import pack_words
from hpc_suffix_array_tpu_torch.kernels.radix import (
    MAX_RADIX, LookBack, onesweep_pass, radix_sort_words)

RESIDUE_SLOTS = 1 << 15          # extracted tie members (the JAX cap)
RESIDUE_WIN = 64     # bytes compared vectorized before the exact fallback
# Largest text the direct builder takes (``SA_DIRECT_MAX``) unless the
# router prefers the MSD builder above ``SA_DIRECT_CROSS``. On an H100
# 80GB HBM3 (700 W) the direct build beat the MSD build at 2^26, 2^27
# and 2^28 random alnum (PERF.md), so the crossover is the direct cap.
DIRECT_MAX = 1 << 28
DIRECT_CROSS = DIRECT_MAX
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


# The host-only planning steps carry a profiler span: numpy work shows in
# no trace by itself, and these are the device's longest idle gaps
# (PERF.md). Outside a profiler a span costs about a microsecond.
@torch.profiler.record_function("host: estimate_repeat_len")
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
    if n > int(os.environ.get("SA_DIRECT_MAX", DIRECT_MAX)):
        return False
    return (residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                             sigma=sigma)
            or residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                                words=3, sigma=sigma))


def prefer_direct(arr: np.ndarray, n: int,
                  est_repeat: int | None = None,
                  sigma: int | None = None) -> bool:
    """The routers' choice between the direct and MSD builders (the JAX
    package's rule): direct when feasible up to ``SA_DIRECT_CROSS``, and
    above it only for chain-class texts. The JAX package's crossover,
    2^27, was measured on a TPU v5e; the port's default,
    ``DIRECT_CROSS``, on an H100 (see its comment)."""
    if not direct_feasible(arr, n, est_repeat, sigma=sigma):
        return False
    if n <= int(os.environ.get("SA_DIRECT_CROSS", DIRECT_CROSS)):
        return True
    if est_repeat is None:
        est_repeat = estimate_repeat_len(arr)
    return chain_plausible(est_repeat, n)


# --- device pieces --------------------------------------------------------

def direct_keys(text: torch.Tensor, remap: np.ndarray, bits: int, spw: int,
                nw: int, minpad: bool) -> list[torch.Tensor]:
    """The ``nw`` carried key words (int32[n] each) of uint8 ``text``:
    word w packs the spw codes from i + w*spw, 0 past n (the JAX
    package's ``_direct_keys`` without its PAD_KEY rows), in one K1
    launch."""
    table_t = key_table(remap, minpad, text.device)
    return pack_words(text, table_t, bits, spw, text.shape[0], nw)


def key_table(remap: np.ndarray, minpad: bool, device) -> torch.Tensor:
    """The pack kernel's int32[256] code table of the carried keys:
    ``remap`` (codes 1..sigma, 0 past the end), or under minpad
    ``max(remap - 1, 0)`` (codes 0..sigma-1, past the end the minimum)."""
    table = np.maximum(remap - 1, 0) if minpad else remap
    return torch.as_tensor(table.astype(np.int32)).to(device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


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
              desc_idx: bool, want_lcp: bool, prev=None):
    """The pass after the sort: the JAX package's ``_bucket_sort`` (one
    bucket of the MSD build, or the whole text as one bucket) and
    ``_direct_sort3`` in one, over 2 or 3 sorted key words of m rows.

    Returns (tie bool[m], stats int64[3] = (tie count, dmax, delta_ok),
    lcp int32[m] or None). ``tie[j]``: row j's key words equal row
    j-1's; row 0 never ties (buckets differ in their keys). ``delta`` is
    the index step along ties (descending in chain mode); ``delta_ok``
    says every tie has the same step >= 1. The LCP of a non-tied pair is
    the first differing symbol of the keys, from the highest set bit of
    their xor. Row 0 compares with ``prev``, the key words of the row
    before it (the previous live bucket's last row: one-element tensors,
    one per word), or with a -1 sentinel when None, whose bit 31 puts
    the symbol below 0, clamped to 0. ``n`` is the text length: in chain
    mode a tied pair's LCP is ``n - prev_idx`` (consecutive chain
    members)."""
    dev = s_idx.device
    big = 1 << 30
    m = s_idx.shape[0]
    tie = torch.zeros(m, dtype=torch.bool, device=dev)
    if m > 1:
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
    lcp = torch.full((m,), nw * spw, dtype=torch.int32, device=dev)
    # Word by word from the last: the first differing word wins.
    for w in reversed(range(nw)):
        head = (torch.full((1,), -1, dtype=torch.int32, device=dev)
                if prev is None else prev[w])
        x = torch.cat([head, words[w][:-1]]) ^ words[w]
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


class ResidueDepthError(Exception):
    """A residue tie is undecided within a bounded-window text view.

    Raised only by views that cannot read the whole text (the
    multi-process ``parallel/bigsort.py::_GatheredView``); callers fall
    back to the doubling builder, which resolves ties of any depth."""


class _ArrView:
    """Whole-text accessor for residue resolution.

    The view contract (shared with ``parallel/bigsort.py::
    _GatheredView``): fetch(idxs, K) -> int16[len(idxs), K] suffix
    windows, -1 past the end (a shorter suffix that is a prefix orders
    first); suffix_less(a, b) / suffix_lcp(a, b): exact order / lcp for
    the rare pairs equal through the whole RESIDUE_WIN window."""

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
    whole window.

    ``arr`` is the host text (uint8[n]) or a view with the ``_ArrView``
    contract: the multi-process build passes one backed by window
    gathers, so no process needs the whole text."""
    view = arr if hasattr(arr, "fetch") else _ArrView(arr, n)
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
        if hasattr(view, "prefetch"):
            # A window-gathering view reads every undecided member in one
            # batch, not one gather per comparison.
            view.prefetch(sorted({int(out[j]) for lo, hi in
                                  zip(run_edges[::2], run_edges[1::2])
                                  for j in range(lo, hi + 1)}))
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
    if len(deep) and hasattr(view, "prefetch"):
        view.prefetch(sorted({int(out[j]) for j in deep}
                             | {int(out[j + 1]) for j in deep}))
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


# --- the MSD bucket builder -------------------------------------------------

# Rows one bucket sort may hold (``max_bucket_elems``). On an H100 80GB
# HBM3 a bucket's sort and post-sort pass held about 44 B a row beside
# the slabs (MSD peak 18.69 GiB at 2^30 with 2^24-row buckets, 23.51 GiB
# with 2^27; PERF.md), so at 2^28 rows a bucket adds about 11 GiB to the
# 36.70 GiB of a 2^31 - 1 build: memory allows the cap, which is also the
# direct route's whole-text sort. A bucket past it holds over a quarter
# of a 2^30 text: too degenerate a prefix distribution for this path,
# and the router falls back.
MAX_PASS_ELEMS = 1 << 28
# Positions per chunk of the count pass and the scatter
# (``SA_CHUNK_ELEMS``) and target rows per bucket (``SA_TARGET_BUCKET``).
# The JAX package's 7 * 2^20 and 8,060,000 were set by TPU v5e sort-
# network classes. On an H100 (PERF.md, 2^30 random alnum) chunks of 2^24
# to 2^27 moved count + scatter (79-88 ms) less than the run-to-run
# spread, and buckets of 2^25 (686-694 ms a build) beat 2^23 and 2^24
# (740-807 ms) and matched 2^26-2^27 with less memory.
CHUNK_ELEMS = 1 << 26
TARGET_BUCKET = 1 << 25


@dataclass
class BigPlan:
    """Host-side plan: geometry, alphabet packing, bucket edges."""

    n: int
    m: int                      # chunk width (position space)
    n_chunks: int
    bits: int                   # bits per dense symbol code
    spw: int                    # symbols packed per key word (30 // bits)
    remap: np.ndarray           # uint8 -> dense code (1..sigma), int32[256]
    e0: np.ndarray              # int32[E] edge k0 words
    e1: np.ndarray              # int32[E] edge k1 words (all 0: k0-only)
    minpad: bool = False        # 0-based codes, past-end = min symbol
    counts: np.ndarray | None = None    # (C, NB) run lengths
    meta: dict = field(default_factory=dict)

    @property
    def n_buckets(self) -> int:
        return len(self.e0) + 1


def _host_pack_words(arr, remap, pos, spw: int, bits: int, word: int,
                     minpad: bool = False):
    """k{word} for sampled positions (host mirror of the device packing)."""
    n = len(arr)
    shift = 1 if minpad else 0
    out = np.zeros(len(pos), np.int64)
    for s in range(spw):
        p = pos + word * spw + s
        code = np.where(p < n, remap[arr[np.minimum(p, n - 1)]] - shift, 0)
        out = (out << bits) | code
    return out


def _pack_sampled(text: torch.Tensor, remap, pos, spw: int, bits: int,
                  word: int, minpad: bool = False) -> np.ndarray:
    """``_host_pack_words`` on a uint8 tensor: the positions' words are
    gathered and folded where the text lies, and only they come back."""
    n, dev = text.shape[0], text.device
    table = key_table(remap, minpad, dev)
    p = (torch.as_tensor(pos, dtype=torch.int64).to(dev)[:, None]
         + torch.arange(word * spw, (word + 1) * spw, device=dev))
    codes = torch.where(p < n, table[text[p.clamp(max=n - 1)].long()], 0)
    out = torch.zeros(p.shape[0], dtype=torch.int64, device=dev)
    for s in range(spw):
        out = (out << bits) | codes[:, s]
    return out.cpu().numpy()


@torch.profiler.record_function("host: sample_edges")
def sample_edges(arr: np.ndarray, remap, spw: int, bits: int,
                 target_bucket: int, sample: int = 1 << 21,
                 seed: int = 0x5A, k0_only: bool | None = None,
                 with_fracs: bool = False, minpad: bool = False,
                 text_dev: torch.Tensor | None = None):
    """Quantile bucket edges over sampled keys, the JAX package's
    function: (e0, e1) int32 edge words, and with ``with_fracs`` the
    sampled fill fraction of each bucket.

    Prefers k0-only edges (e1 all zeros: the bucket id is a function of
    k0 alone, and the count pass packs one word). Falls back to (k0, k1)
    pair edges when the sampled k0 quantiles predict a bucket over
    ``min(0.7 * MAX_PASS_ELEMS, 4 * target_bucket)`` (heavy first-word
    duplication). ``k0_only`` forces the mode; True raises ValueError
    where k0 alone is too skewed.

    ``text_dev``: the same bytes as a uint8 tensor; the sampled words are
    then packed where it lies (the host gathers of 2^21 random positions
    took about 0.35 s at 2^26, most of an MSD build there). The positions
    and the quantiles stay on the host, so the edges are the same."""
    n = len(arr)
    n_buckets = max(2, math.ceil(n / target_bucket))
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n, min(sample, 4 * n))

    def pack(word):
        if text_dev is None:
            return _host_pack_words(arr, remap, pos, spw, bits, word, minpad)
        return _pack_sampled(text_dev, remap, pos, spw, bits, word, minpad)

    c0 = pack(0)
    if k0_only is not False:
        c0s = np.sort(c0)
        q = (np.arange(1, n_buckets) * len(c0s)) // n_buckets
        e0 = np.unique(c0s[q])
        cuts = np.searchsorted(c0s, e0, side="left")
        sizes = np.diff(np.r_[0, cuts, len(c0s)])
        worst = sizes.max() / max(len(c0s), 1) * n
        if len(e0) and worst <= min(0.7 * MAX_PASS_ELEMS,
                                    4 * target_bucket):
            out = (e0.astype(np.int32), np.zeros(len(e0), np.int32))
            if with_fracs:
                return out + (sizes / max(len(c0s), 1),)
            return out
        if k0_only:
            raise ValueError("k0-only edges requested but the sampled "
                             "k0 distribution is too skewed")
    c1 = pack(1)
    code = (c0.astype(np.int64) << 31) | c1
    code.sort()
    q = (np.arange(1, n_buckets) * len(code)) // n_buckets
    edges = np.unique(code[q])
    out = ((edges >> 31).astype(np.int32),
           (edges & ((1 << 31) - 1)).astype(np.int32))
    if with_fracs:
        cuts = np.searchsorted(code, edges, side="left")
        return out + (np.diff(np.r_[0, cuts, len(code)]) / max(len(code),
                                                               1),)
    return out


def _sample_k0_device(n_edges: int, m_s: int, stride: int, spw: int,
                      bits: int, text: torch.Tensor, table: torch.Tensor,
                      n: int) -> torch.Tensor:
    """k0-only quantile edges, entirely on the text's device (strided
    sample): int32[n_edges], the JAX package's ``_sample_k0_device``.

    The text's first ``m_s * stride`` bytes are viewed as (m_s, stride)
    rows (a view, no gather); the first ``spw`` bytes of each row fold
    into a k0 word as the pack kernel folds them (``table`` is
    ``key_table``'s, 0 past n); the sample is sorted and the quantiles
    read. Rows that start past ``n - spw`` take the sentinel ``2 << 29``,
    above every 30-bit word, and sort past the valid prefix that the
    quantile slots index. Duplicate quantile values are kept (they make
    empty buckets, which the bucket pass skips), so the plan keeps its
    bucket count. Strided sampling is unbiased on non-periodic texts;
    periodic texts run in chain mode, where the edges only balance."""
    dev = text.device
    need = m_s * stride
    if text.shape[0] < need:            # n < stride: one row, zero-filled
        text = torch.cat([text, text.new_zeros(need - text.shape[0])])
    blk = text[:need].reshape(m_s, stride)[:, :spw]
    pos = torch.arange(m_s, dtype=torch.int64, device=dev) * stride
    inside = pos[:, None] + torch.arange(spw, device=dev) < n
    codes = torch.where(inside, table[blk.long()], 0)
    k0 = torch.zeros(m_s, dtype=torch.int32, device=dev)
    for s in range(spw):
        k0 = (k0 << bits) | codes[:, s]
    last = max(n - spw, 1)
    k0 = torch.where(pos < last, k0, 2 << 29)
    k0 = torch.sort(k0).values
    n_valid = min(max(-(-last // stride), 1), m_s)
    q = (torch.arange(1, n_edges + 1, dtype=torch.int64, device=dev)
         * n_valid) // (n_edges + 1)
    return k0[q]


def replan_edges(state: dict, text=None) -> None:
    """Refresh the plan's bucket edges in place (a benchmark's re-plan
    step between timed builds).

    A plan with k0-only edges is re-sampled on the device, with a stride
    of ``n / 2^21`` (at least two words) and at most 2^21 rows; a plan
    with (k0, k1) pair edges goes back through ``sample_edges`` on
    ``text`` (default: the state's host bytes)."""
    plan: BigPlan = state["plan"]
    if not plan.e1.any():
        stride = max(2 * plan.spw, plan.n // (1 << 21) or 1)
        m_s = min(1 << 21, plan.n // stride or 1)
        e0 = _sample_k0_device(len(plan.e0), m_s, stride, plan.spw,
                               plan.bits, state["text_dev"], state["table"],
                               plan.n)
        plan.e0 = e0.cpu().numpy()
        return
    plan.e0, plan.e1 = sample_edges(
        as_byte_array(text if text is not None else state["host_text"]),
        plan.remap, plan.spw, plan.bits, plan.meta["target_bucket"],
        minpad=plan.minpad, text_dev=state["text_dev"])


def chunk_geometry(n: int, chunk_elems: int | None = None
                   ) -> tuple[int, int, int]:
    """(m, n_chunks, text length) of an n-byte MSD build: chunks of
    ``chunk_elems`` positions (``SA_CHUNK_ELEMS``, default
    ``CHUNK_ELEMS``), the last one shorter. The JAX package's third value
    is its zero-padded text length; the port reads past the end as 0
    in the pack kernel, so it is n."""
    if chunk_elems is None:
        chunk_elems = int(os.environ.get("SA_CHUNK_ELEMS", CHUNK_ELEMS))
    m = max(1, min(int(chunk_elems), n))
    return m, -(-n // m), n


def prepare_big(text, *, device, target_bucket: int | None = None,
                chunk_elems: int | None = None, sample: int = 1 << 21,
                text_dev=None, remap: np.ndarray | None = None,
                est_repeat: int | None = None) -> dict:
    """Stage the text on ``device`` and build the host plan (untimed
    setup).

    ``text``: the host bytes (edge sampling and the residue read them).
    ``text_dev``: optional uint8 copy of the same bytes on ``device``
    (see ``device_text``). ``remap``/``est_repeat``: planning products
    the router already computed for the same bytes. ``target_bucket``
    (``SA_TARGET_BUCKET``, default ``TARGET_BUCKET``) is raised to
    ceil(n / ``MAX_RADIX``) where needed, so the bucket id is one digit
    of the scatter's onesweep pass."""
    arr = as_byte_array(text)
    n = int(arr.shape[0])
    if n < 8:
        raise ValueError("bigsort needs n >= 8; use build_suffix_array")
    if target_bucket is None:
        target_bucket = int(os.environ.get("SA_TARGET_BUCKET",
                                           TARGET_BUCKET))
    target_bucket = max(int(target_bucket), -(-n // MAX_RADIX))
    t = device_text(arr, device, text_dev)
    m, n_chunks, _ = chunk_geometry(n, chunk_elems)
    if remap is None:
        remap, _, _ = alphabet_remap_dev(t)
    bits, spw, minpad = packing_mode(remap)
    e0, e1 = sample_edges(arr, remap, spw, bits, target_bucket,
                          sample=sample, minpad=minpad, text_dev=t)
    if est_repeat is None:
        est_repeat = estimate_repeat_len(arr)
    return {
        "plan": BigPlan(n=n, m=m, n_chunks=n_chunks, bits=bits, spw=spw,
                        remap=remap, e0=e0, e1=e1, minpad=minpad,
                        meta={"est_repeat": est_repeat,
                              "target_bucket": target_bucket}),
        "text_dev": t,
        "table": key_table(remap, minpad, t.device),
        "host_text": arr,
    }


def _chunk_keys(state: dict, c: int, n_words: int) -> list[torch.Tensor]:
    """Key words k0 (and k1) of chunk c's positions (0 past n), in one
    K1 launch over the chunk's rows."""
    plan = state["plan"]
    s = c * plan.m
    e = min(s + plan.m, plan.n)
    return pack_words(state["text_dev"], state["table"], plan.bits,
                      plan.spw, plan.n, n_words, offset=s, n_out=e - s)


def _bucket_ids(keys, edges: torch.Tensor) -> torch.Tensor:
    """int32 bucket id of each position: the number of edges at or below
    its key, k0 for k0-only edges (int32 ``edges``), else the 62-bit
    ``k0 << 31 | k1`` (int64 ``edges``)."""
    if edges.dtype == torch.int32:
        key = keys[0]
    else:
        key = (keys[0].long() << 31) | keys[1].long()
    return torch.searchsorted(edges, key, right=True, out_int32=True)


def _plan_edges(plan: BigPlan, device) -> torch.Tensor:
    if not plan.e1.any():
        return torch.as_tensor(plan.e0.astype(np.int32)).to(device)
    code = (plan.e0.astype(np.int64) << 31) | plan.e1.astype(np.int64)
    return torch.as_tensor(code).to(device)


def _count_pass(state: dict, edges: torch.Tensor) -> np.ndarray:
    """(C, NB) int64: positions of chunk c in bucket b (the JAX package's
    ``_count_chunks``, differenced); one host read."""
    plan = state["plan"]
    n_words = 1 if edges.dtype == torch.int32 else 2
    rows = []
    for c in range(plan.n_chunks):
        bid = _bucket_ids(_chunk_keys(state, c, n_words), edges)
        rows.append(torch.bincount(bid, minlength=plan.n_buckets))
    return torch.stack(rows).cpu().numpy().astype(np.int64)


def _scatter(state: dict, edges: torch.Tensor, counts: np.ndarray,
             dest: np.ndarray) -> list[torch.Tensor]:
    """Slabs (bid, k0, k1, idx), int32[n] each: one onesweep pass per
    chunk by the bucket id, chunk c's bucket-b run landing at
    ``dest[c, b]``."""
    plan, dev = state["plan"], state["text_dev"].device
    n, nb = plan.n, plan.n_buckets
    rbits = max(1, (nb - 1).bit_length())
    slabs = [torch.empty(n, dtype=torch.int32, device=dev)
             for _ in range(4)]
    starts = np.zeros((plan.n_chunks, 1 << rbits), np.int32)
    starts[:, :nb] = dest
    starts = torch.as_tensor(starts).to(dev)
    lookback = LookBack(plan.m, plan.n_chunks, dev)
    for c in range(plan.n_chunks):
        keys = _chunk_keys(state, c, 2)
        bid = _bucket_ids(keys, edges)
        s = c * plan.m
        idx = torch.arange(s, s + bid.shape[0], dtype=torch.int32,
                           device=dev)
        onesweep_pass([bid, *keys, idx], 0, 0, rbits, starts[c], lookback,
                      out=slabs, digit_counts=counts[c])
    return slabs


class _DeviceSpans:
    """Summed device time of named spans between CUDA events (none on
    other devices); read once the work has finished."""

    def __init__(self, dev: torch.device):
        self.on = dev.type == "cuda"
        self.marks: list[tuple[str, torch.cuda.Event]] = []
        self.mark("start")

    def mark(self, name: str) -> None:
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))

    def totals_ms(self) -> dict:
        out: dict = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return {k: round(v, 3) for k, v in out.items()}


def _bucket_pass(state: dict, slabs, base: np.ndarray, fills: np.ndarray,
                 live: list[int], chain_mode: bool, want_lcp: bool):
    """Sort every live bucket in place and finish it with ``post_sort``.

    Returns (tie bool[n], stats int64[L, 3] per live bucket, device ms
    of the sorts and post-sort passes). The LCP of bucket b goes into
    the bucket-id slab at b's region."""
    plan = state["plan"]
    bid_s, k0_s, k1_s, idx_s = slabs
    tie = torch.zeros(plan.n, dtype=torch.bool, device=idx_s.device)
    spans = _DeviceSpans(idx_s.device)
    stats, prev = [], None
    for b in live:
        a, z = int(base[b]), int(base[b] + fills[b])
        k0, k1, idx = k0_s[a:z], k1_s[a:z], idx_s[a:z]
        if chain_mode:                  # stable sort of reversed input
            for col in (k0, k1, idx):
                col.copy_(col.flip(0))
        radix_sort_words([k0, k1], idx, plan.bits * plan.spw)
        spans.mark("bucket_sort")
        t_b, s_b, lcp_b = post_sort([k0, k1], idx, plan.n, plan.spw,
                                    plan.bits, chain_mode, want_lcp, prev)
        tie[a:z] = t_b
        if want_lcp:
            bid_s[a:z] = lcp_b
        stats.append(s_b)
        prev = (k0[-1:], k1[-1:])
        spans.mark("post_sort")
    stats = torch.stack(stats).cpu().numpy()        # the pass's host read
    return tie, stats, spans.totals_ms()


def execute_big(state: dict, *, max_bucket_elems: int | None = None,
                force_chain_mode: bool | None = None,
                want_lcp: bool = False):
    """Count, scatter and bucket passes; returns the SA (and the LCP with
    ``want_lcp``), int32[n] on the state's device.

    Chain mode (chosen from the repeat estimate, or forced) checks every
    tied bucket's delta and its global period; a misprediction reruns
    ascending (``meta["rerun"]``: ``chain_to_ascending``), and an
    ascending run that ties over a quarter of a chain-plausible text
    reruns in chain mode (``ascending_to_chain``). Ascending ties go to
    the host residue while every bucket's members fit ``RESIDUE_SLOTS``
    and all flags fit ``SA_HOST_RESIDUE_MAX``; past that the device
    refinement (``core/refine.py``) orders them. Raises
    NotImplementedError on bucket skew (a bucket over
    ``max_bucket_elems``, default ``MAX_PASS_ELEMS``), where forced chain
    mode does not hold, and ``RefineOverflow`` past a refinement cap.

    ``meta`` (``state["plan"].meta``) receives ``n_buckets_run``,
    ``chain_mode``, ``periods``, ``n_patched``, ``phase_host_s`` (host
    clock between synced phase ends: count, scatter, bucket_sorts,
    residue_extract, finish) and, on CUDA, ``phase_device_ms`` (the
    bucket sorts and post-sort passes, summed)."""
    plan: BigPlan = state["plan"]
    meta = plan.meta
    n, nb = plan.n, plan.n_buckets
    t = state["text_dev"]
    dev = t.device
    stamps = [("start", time.perf_counter())]
    chain_mode = force_chain_mode
    if chain_mode is None:
        chain_mode = chain_plausible(meta.get("est_repeat", 0), n)

    edges = _plan_edges(plan, dev)
    counts = _count_pass(state, edges)
    plan.counts = counts
    fills = counts.sum(axis=0)
    if int(fills.sum()) != n:
        raise RuntimeError(f"bucket counts sum to {int(fills.sum())}, "
                           f"not n={n}")
    stamps.append(("count", time.perf_counter()))
    pass_cap = max_bucket_elems or MAX_PASS_ELEMS
    if int(fills.max()) > pass_cap:
        raise NotImplementedError(
            f"bucket skew: one bucket holds {int(fills.max())} of n={n} "
            f"elements (> {pass_cap}); the text's prefix distribution is "
            "too degenerate for the MSD path")
    # Exact counts, so no gaps: bucket b's region is its final SA range,
    # and chunk c's run of b follows the runs of the chunks before it.
    base = np.concatenate([[0], np.cumsum(fills)[:-1]]).astype(np.int64)
    dest = base[None, :] + np.concatenate(
        [np.zeros((1, nb), np.int64), np.cumsum(counts, axis=0)[:-1]])
    slabs = _scatter(state, edges, counts, dest)
    _sync(dev)
    stamps.append(("scatter", time.perf_counter()))

    live = [b for b in range(nb) if fills[b]]
    tie, stats, dev_ms = _bucket_pass(state, slabs, base, fills, live,
                                      chain_mode, want_lcp)
    sa = slabs[3]
    lcp = slabs[0] if want_lcp else None
    del slabs                           # the key slabs are dead
    stamps.append(("bucket_sorts", time.perf_counter()))
    tie_counts = stats[:, 0]

    def rerun(kind: str, force: bool):
        meta.setdefault("rerun", []).append(kind)
        return execute_big(state, max_bucket_elems=max_bucket_elems,
                           force_chain_mode=force, want_lcp=want_lcp)

    verified: set[int] = set()
    if chain_mode:
        for b, (ties, d, dok) in zip(live, stats.tolist()):
            if not ties:
                continue
            if not dok:
                if force_chain_mode is None:
                    sa = lcp = tie = None       # free before re-running
                    return rerun("chain_to_ascending", False)
                raise NotImplementedError(
                    f"bucket {b}: residual ties are not uniform arithmetic "
                    "chains")
            if d and d not in verified:
                mm = _period_mismatches(t, d, n)
                if mm:
                    if force_chain_mode is None:
                        sa = lcp = tie = None
                        return rerun("chain_to_ascending", False)
                    raise NotImplementedError(
                        f"bucket {b}: chain delta {d} is not a global "
                        f"period ({mm} mismatches)")
                verified.add(d)
    elif (int(tie_counts.sum()) > n // 4
          and chain_plausible(meta.get("est_repeat", 0), n)
          and "chain_to_ascending" not in meta.get("rerun", [])):
        sa = lcp = tie = None
        return rerun("ascending_to_chain", True)

    # The host residue's bound is per bucket (RESIDUE_SLOTS members each;
    # members <= 2 * flags + groups, so the flags predict an overflow
    # before any extraction); the global cap bounds the host lexsort.
    patches = []
    refine = False
    host_cap = int(os.environ.get("SA_HOST_RESIDUE_MAX", 1 << 20))
    if not chain_mode and tie_counts.sum():
        refine = (int(tie_counts.max()) * 2 > RESIDUE_SLOTS
                  or int(tie_counts.sum()) > host_cap)
        if not refine:
            slots, idxs = _extract_ties(tie, sa)
            bounds = torch.as_tensor(
                np.r_[base[live], n].astype(np.int64)).to(dev)
            cuts = torch.searchsorted(slots, bounds).tolist()
            refine = max(np.diff(cuts)) > RESIDUE_SLOTS
            if not refine:
                slots, idxs = slots.cpu().numpy(), idxs.cpu().numpy()
                patches = [(slots[a:z], idxs[a:z])
                           for a, z in zip(cuts, cuts[1:]) if z > a]
    stamps.append(("residue_extract", time.perf_counter()))

    n_patched = 0
    if refine:
        from hpc_suffix_array_tpu_torch.core.refine import refine_ties

        sa, lcp = refine_ties(
            sa, tie, lcp, t, remap=plan.remap, spw_main=plan.spw, nw=2,
            minpad=plan.minpad, host_text=state["host_text"],
            want_lcp=want_lcp, meta=meta)
        n_patched = meta["refine_host_members"]
    del tie
    if patches:
        sa, lcp, n_patched = _apply_residue(
            sa, lcp, state["host_text"], patches, n, want_lcp)
    if want_lcp and plan.minpad:
        # After the residue and refinement patches (see _clamp_lcp).
        lcp = _clamp_lcp(sa, lcp, n)
    _sync(dev)
    stamps.append(("finish", time.perf_counter()))

    meta.update(n_buckets_run=len(live), chain_mode=chain_mode,
                periods=sorted(verified), n_patched=n_patched)
    meta["phase_host_s"] = {
        name: round(t1 - t0, 4)
        for (_, t0), (name, t1) in zip(stamps, stamps[1:])}
    if dev_ms:
        meta["phase_device_ms"] = dev_ms
    return (sa, lcp) if want_lcp else sa


def build_suffix_array_big(text, *, device, info: dict | None = None,
                           want_lcp: bool = False,
                           max_bucket_elems: int | None = None, **kw):
    """One-call MSD build (``prepare_big`` + ``execute_big``); ``kw`` go
    to ``prepare_big``.

    ``info``: optional dict that receives the plan's ``rerun``,
    ``chain_mode``, ``n_patched``, ``periods`` and, where refinement
    ran, ``refine_members``, ``refine_rounds``, ``refine_pieces``,
    ``refine_host_members`` (the JAX package's keys), plus
    ``refine_phase_s``, ``n_buckets_run``, ``phase_host_s`` and
    ``phase_device_ms``."""
    state = prepare_big(text, device=device, **kw)
    out = execute_big(state, max_bucket_elems=max_bucket_elems,
                      want_lcp=want_lcp)
    if info is not None:
        info.update({k: v for k, v in state["plan"].meta.items()
                     if k in ("rerun", "chain_mode", "n_patched",
                              "periods", "refine_members",
                              "refine_rounds", "refine_pieces",
                              "refine_host_members", "refine_phase_s",
                              "n_buckets_run", "phase_host_s",
                              "phase_device_ms")})
    return out
