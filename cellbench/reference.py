"""The plain reference: judges a text's suffix array, LCP array and
longest repeated substring, in plain PyTorch, on any device.

A text has one suffix array and one LCP array, so an array that passes
these checks is equal to the reference's. The checks are deterministic
and O(n), and each number they return counts what is wrong (0 when the
answer is exact):

  * ``sa_bad``: values of 0..n-1 missing from ``sa`` (it must be a
    permutation), plus adjacent pairs out of order. With ``rank`` the
    inverse of ``sa`` and rank(n) = -1, ``sa`` is the suffix array iff
    it is a permutation and every adjacent pair (a, b) has
    (text[a], rank[a+1]) < (text[b], rank[b+1]) (Burkhardt and
    Kärkkäinen, 2003);
  * ``lcp_bad``: LCP entries whose claim fails. lcp[0] must be 0. For
    text position i with predecessor p in ``sa`` and claim L = PLCP[i],
    Kasai's lemma gives PLCP[i] >= PLCP[i-1] - 1, so with every earlier
    claim proven the first max(PLCP[i-1] - 1, 0) characters of i and p
    are known equal; the check compares the rest of the claimed prefix
    character by character and requires a mismatch (or an end) at L.
    By induction over i, all claims pass iff all are true. The
    characters compared number at most n plus the largest LCP;
  * ``lrs_bad``: 1 unless the longest repeated substring has the
    length of the largest LCP and occurs at least twice (counted by
    binary search in the proven suffix array), or is None when no
    character repeats.

Nothing here imports the program: the caller hands in the text it made
and the program's outputs, which are only read to be judged.
"""

from __future__ import annotations

import numpy as np
import torch

# The configurations state exact answers: every count must be 0.
LIMITS = {"sa_bad": 0, "lcp_bad": 0, "lrs_bad": 0}
# Positions per block of the O(n) passes.
BLOCK = 1 << 24
# Character pairs per gather of the prefix compare.
RAGGED = 1 << 25
# A claimed prefix longer than this is compared as two slices.
LONG = 1 << 12


def judge(text: np.ndarray, sa, lcp, lrs, device) -> dict:
    """``{"sa_bad", "lcp_bad", "lrs_bad"}`` of the outputs ``sa``, ``lcp``
    (int32[n] tensors or arrays) and ``lrs`` (bytes or None) for the
    host bytes ``text``."""
    dev = torch.device(device)
    n = int(len(text))
    t = torch.from_numpy(np.array(text, np.uint8)).to(dev)
    sa = torch.as_tensor(sa).to(dev)
    lcp = torch.as_tensor(lcp).to(dev)
    if tuple(sa.shape) != (n,) or tuple(lcp.shape) != (n,):
        return {"sa_bad": n, "lcp_bad": n, "lrs_bad": 1}
    if n == 0:
        return {"sa_bad": 0, "lcp_bad": 0, "lrs_bad": int(bool(lrs))}
    sa_bad, rank = check_sa(t, sa)
    lcp_bad = check_lcp(t, sa, lcp, rank)
    del rank
    return {"sa_bad": sa_bad, "lcp_bad": lcp_bad,
            "lrs_bad": check_lrs(t, sa, lcp, lrs)}


def check_sa(t: torch.Tensor, sa: torch.Tensor):
    """(bad count, int32[n + 1] rank with rank[n] = -1) of ``sa``."""
    n, dev = t.shape[0], t.device
    rank = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    for s in range(0, n, BLOCK):
        blk = sa[s:s + BLOCK].long()
        ok = (blk >= 0) & (blk < n)
        pos = torch.arange(s, s + blk.shape[0], dtype=torch.int32,
                           device=dev)
        rank[blk[ok]] = pos[ok]
    # n entries in n slots: a value is missing for each duplicate and
    # each entry out of range.
    bad = int((rank[:n] < 0).sum())
    for s in range(1, n, BLOCK):
        e = min(n, s + BLOCK)
        a = sa[s - 1:e - 1].long().clamp(0, n - 1)
        b = sa[s:e].long().clamp(0, n - 1)
        ca, cb = t[a], t[b]
        ok = (ca < cb) | ((ca == cb) & (rank[a + 1] < rank[b + 1]))
        bad += int((~ok).sum())
    return bad, rank


def check_lcp(t: torch.Tensor, sa: torch.Tensor, lcp: torch.Tensor,
              rank: torch.Tensor) -> int:
    """Count of LCP claims that fail (see the module docstring)."""
    n, dev = t.shape[0], t.device
    bad = int(lcp[0] != 0)
    budget = 2 * n + 2          # characters a true LCP array needs, at most
    for s in range(0, n, BLOCK):
        e = min(n, s + BLOCK)
        i = torch.arange(s, e, device=dev)
        r = rank[s:e].long()
        has = r > 0
        rc = r.clamp(min=1)
        p = sa[rc - 1].long().clamp(0, n - 1)
        claim = lcp[rc].long()
        r_prev = rank[(i - 1).clamp(min=0)].long()
        prev = torch.where((i > 0) & (r_prev > 0),
                           lcp[r_prev.clamp(min=0)].long(),
                           torch.zeros_like(claim))
        start = (prev - 1).clamp(min=0)
        room = n - torch.maximum(p, i)
        fail = has & ((claim < start) | (claim > room))
        live = has & ~fail
        at_end = claim == room
        q, u = (p + claim).clamp(max=n - 1), (i + claim).clamp(max=n - 1)
        fail |= live & ~at_end & (t[q] == t[u])
        lens = torch.where(live, claim - start, torch.zeros_like(claim))
        total = int(lens.sum())
        if total > budget:
            # Only wrong claims need more: count every one left.
            fail |= lens > 0
        else:
            budget -= total
            fail |= prefix_mismatch(t, p + start, i + start, lens)
        bad += int(fail.sum())
    return bad


def prefix_mismatch(t: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """bool[m]: whether t[x_k + j] != t[y_k + j] for some j < lens_k."""
    out = torch.zeros(lens.shape[0], dtype=torch.bool, device=t.device)
    long_k = torch.nonzero(lens > LONG).flatten().tolist()
    for k in long_k:
        a, b, m = int(x[k]), int(y[k]), int(lens[k])
        out[k] = not torch.equal(t[a:a + m], t[b:b + m])
    lens = torch.where(lens > LONG, torch.zeros_like(lens), lens)
    cum = torch.cumsum(lens, 0)
    m = lens.shape[0]
    s = 0
    while s < m:
        base = int(cum[s - 1]) if s else 0
        e = int(torch.searchsorted(cum, base + RAGGED, right=True))
        e = min(max(e, s + 1), m)
        total = int(cum[e - 1]) - base
        if total:
            owner = torch.repeat_interleave(
                torch.arange(s, e, device=t.device), lens[s:e])
            off = (torch.arange(total, device=t.device) + base
                   - (cum[owner] - lens[owner]))
            mis = t[x[owner] + off] != t[y[owner] + off]
            out[owner[mis]] = True
        s = e
    return out


def check_lrs(t: torch.Tensor, sa: torch.Tensor, lcp: torch.Tensor,
              lrs) -> int:
    """0 when ``lrs`` is a longest repeated substring, else 1."""
    longest = int(lcp.max())
    if longest == 0:
        return int(bool(lrs))
    if lrs is None or len(lrs) != longest:
        return 1
    return int(occurrences(t, sa, bytes(lrs)) < 2)


def occurrences(t: torch.Tensor, sa: torch.Tensor, pattern: bytes) -> int:
    """How many suffixes start with ``pattern`` (binary search in the
    sorted ``sa``)."""
    n, m = t.shape[0], len(pattern)

    def head(j: int) -> bytes:
        s = int(sa[j])
        return t[s:s + m].cpu().numpy().tobytes()

    def first(pred) -> int:
        lo, hi = 0, n
        while lo < hi:
            mid = (lo + hi) // 2
            if pred(head(mid)):
                hi = mid
            else:
                lo = mid + 1
        return lo

    return first(lambda h: h > pattern) - first(lambda h: h >= pattern)
