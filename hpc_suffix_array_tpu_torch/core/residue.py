"""The exact finish of tied suffixes, below every carried-keys builder.

Suffixes whose carried key words are equal are tied. Here are what every
finisher of them shares: the member extraction (``extract_ties``), the
depth the keys proved (``key_depth``), the exact host closer
(``resolve_residue_host``, by doubling byte windows from that depth) and
its patches (``apply_residue``, ``apply_patch``), the minpad LCP clamp
(``clamp_lcp``) and chain mode's period check (``period_mismatches``).
"""

from __future__ import annotations

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.utils.profiling import count, span

RESIDUE_SLOTS = 1 << 15          # extracted tie members (the JAX cap)
RESIDUE_WIN = 64     # bytes of the host residue's first extension step
# Rows x window bytes one extension step of the host residue may read;
# the window doubles each step up to this budget.
RESIDUE_STEP_BYTES = 1 << 24


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def extract_ties(tie: torch.Tensor):
    """(slots int64[P], head bool[P]) of every tie-group member, slots
    ascending; ``head`` marks each group's first member. A group
    contributes all its members: the flag marks the later element of
    each tied pair, heads join via their successor."""
    member = tie.clone()
    member[:-1] |= tie[1:]
    slots = torch.nonzero(member).view(-1)
    del member
    return slots, ~tie[slots]


def key_depth(nw: int, spw: int, minpad: bool) -> int:
    """Symbols through which equal carried keys prove two suffixes equal:
    ``nw * spw`` under reserved-0 packing, 0 under minpad (a suffix that
    ends inside the window pads with the minimum symbol)."""
    return 0 if minpad else nw * spw


def apply_patch(sa: torch.Tensor, slots: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
    """Write ``vals`` into ``sa`` at ``slots``, in place, dropping pad
    slots (-1). They are never clamped to slot 0: with a real patch
    there too, two writes to one index have no defined order (the
    ``_apply_patch`` fault the JAX package fixed)."""
    keep = slots >= 0
    sa[slots[keep]] = vals[keep].to(sa.dtype)
    return sa


def clamp_lcp(sa: torch.Tensor, lcp: torch.Tensor, n: int) -> torch.Tensor:
    """Final shorter-suffix clamp: lcp[j] <= n - max(sa[j-1], sa[j]).

    Under minpad packing a suffix ending inside the window continues as
    min-symbol pads, so the key-derived value can overshoot; the clamp
    runs over the final (post-residue) SA. Row 0 pairs with itself."""
    prev = torch.cat([sa[:1], sa[:-1]])
    return torch.minimum(lcp, n - torch.maximum(prev, sa))


def period_mismatches(text: torch.Tensor, d: int, n: int) -> int:
    """#positions t in [0, n-d) with text[t] != text[t+d]."""
    if d >= n:
        return 0
    return int((text[:n - d] != text[d:n]).sum())


# --- host residue (numpy) ---------------------------------------------------

def suffix_lcp(arr: np.ndarray, a: int, b: int, n: int,
               step: int = 4096) -> int:
    """Exact LCP of suffixes a and b by bounded windows (host)."""
    m = n - max(a, b)                   # the shorter suffix's length
    for off in range(0, m, step):
        L = min(step, m - off)
        neq = np.flatnonzero(arr[a + off:a + off + L]
                             != arr[b + off:b + off + L])
        if len(neq):
            return off + int(neq[0])
    return m                            # one is a prefix of the other


def suffix_less(arr: np.ndarray, a: int, b: int, n: int,
                step: int = 4096) -> bool:
    """Exact suffix comparison by bounded windows (host)."""
    k = suffix_lcp(arr, a, b, n, step)
    if k == n - max(a, b):
        return a > b                # equal through the shorter's end
    return bool(arr[a + k] < arr[b + k])


class ResidueDepthError(Exception):
    """A residue tie is undecided within a view's ``DEEP_WIN``; callers
    fall back to the doubling builder, which resolves ties of any
    depth."""


class _ArrView:
    """Whole-text accessor for residue resolution.

    The view contract (shared with ``parallel/bigsort.py::
    _GatheredView``): fetch(starts, K) -> uint8[len(starts), K], the K
    bytes from each start, 0 past the end of the text (the closer knows
    each row's length and orders a shorter suffix that is a prefix
    first). A view may bound the depth it serves with ``DEEP_WIN``; this
    one reads the whole text."""

    def __init__(self, arr: np.ndarray, n: int):
        self.arr, self.n = arr, n

    def fetch(self, starts: np.ndarray, K: int) -> np.ndarray:
        starts = np.asarray(starts, np.int64)
        out = np.zeros((len(starts), K), np.uint8)
        inner = starts <= self.n - K
        if inner.any():
            out[inner] = np.lib.stride_tricks.sliding_window_view(
                self.arr[:self.n], K)[starts[inner]]
        # Fewer than K distinct starts reach past the end.
        for i in np.flatnonzero(~inner):
            tail = self.arr[starts[i]:self.n]
            out[i, :len(tail)] = tail
        return out


def resolve_residue_host(arr, slots: np.ndarray, idxs: np.ndarray, n: int,
                         want_lcp: bool = False, heads=None,
                         depth: int = 0):
    """Exact order for the tied elements (host comparison).

    Groups are the segments that ``heads`` (bool, aligned to ``slots``)
    starts, each tied through its first ``depth`` symbols; with
    ``heads=None`` they are runs of consecutive slots, read from depth 0
    (touching runs merge there, which is harmless at depth 0). Order
    within each group = full suffix order. Returns (ascending slots, idx
    aligned to them, lcp-patch slots, lcp-patch values). The lcp patches
    cover every group-internal adjacent pair; the lcp at a group's head
    is invariant under the reorder and kept (the key-derived value,
    exact under reserved-0 packing, or under minpad after the final
    ``clamp_lcp``, which must run after this patch; or the value the
    refinement round that split the groups recorded).

    Vectorized, by extension steps over the still-tied rows only: each
    reads the W bytes from ``idx + off`` (``off`` from ``depth``, W from
    ``RESIDUE_WIN`` doubling while rows x W stays within
    ``RESIDUE_STEP_BYTES``), sorts the rows by (group, window, bytes
    left) with one argsort of big-endian byte records, splits groups
    where the windows differ and records ``off + first differing byte``
    at each new boundary. Past-the-end bytes read 0 and the bytes-left
    key orders a shorter suffix that is a prefix first, so the order and
    the LCPs are exact at any depth in about log2(deepest tie) steps; no
    Python loop runs over pairs.

    ``arr`` is the host text (uint8[n]) or a view with the ``_ArrView``
    contract: the multi-process build passes one backed by window
    gathers, so no process needs the whole text; a view's ``DEEP_WIN``
    bounds the depth read, past which ResidueDepthError is raised.
    Counts ``residue_members`` and ``residue_steps``."""
    view = arr if hasattr(arr, "fetch") else _ArrView(arr, n)
    order = np.argsort(slots, kind="stable")
    slots, out = slots[order], idxs[order].copy()
    P = len(slots)
    if P == 0:
        return slots, out, np.zeros(0, np.int64), np.zeros(0, np.int32)
    if heads is None:
        head, depth = np.r_[True, np.diff(slots) != 1], 0
    else:
        head = np.asarray(heads, bool)[order]
        head[0] = True
    count("residue_members", P)
    lcp = np.full(P, -1, np.int64)
    seg = np.cumsum(head) - 1
    rows = np.flatnonzero(_tied(head))
    seg = seg[rows]
    limit = getattr(view, "DEEP_WIN", None)
    off, W, steps = int(depth), RESIDUE_WIN, 0
    while len(rows):
        if limit is not None:
            if off >= limit:
                raise ResidueDepthError(
                    f"suffixes {int(out[rows[0]])} and {int(out[rows[1]])} "
                    f"tie past {limit} bytes")
            W = min(W, limit - off)
        # One record per row: segment, window (0 past the end, padded
        # to whole words) and bytes left, all big-endian, so one sort
        # of the raw records (numpy compares void bytes as unsigned,
        # first to last) orders by (segment, window, bytes left).
        Wp = -(-W // 8) * 8
        starts = out[rows].astype(np.int64) + off
        left = np.clip(n - starts, 0, W)
        rec = np.zeros((len(rows), Wp + 16), np.uint8)
        rec[:, :8] = _be_bytes(seg)
        rec[:, 8:8 + W] = view.fetch(starts, W)
        rec[:, 8 + Wp:] = _be_bytes(left)
        o = np.argsort(rec.view(np.dtype((np.void, Wp + 16))).ravel())
        out[rows] = out[rows][o]
        rec, seg, left = rec[o], seg[o], left[o]
        words = rec.view(np.uint64)
        diff = (words[1:] != words[:-1]).any(axis=1)
        if want_lcp:
            # A new boundary inside an old segment gets its exact LCP.
            j = np.flatnonzero(diff & (seg[1:] == seg[:-1]))
            neq = rec[j + 1, 8:8 + W] != rec[j, 8:8 + W]
            first = np.where(neq.any(axis=1), np.argmax(neq, axis=1), W)
            lcp[rows[j + 1]] = off + np.minimum(
                first, np.minimum(left[j], left[j + 1]))
        new_head = np.r_[True, diff]
        keep = _tied(new_head)
        rows, seg = rows[keep], (np.cumsum(new_head) - 1)[keep]
        off += W
        fit = RESIDUE_STEP_BYTES // max(len(rows), 1)
        W = max(RESIDUE_WIN, min(2 * W, 1 << (fit.bit_length() - 1)))
        steps += 1
    count("residue_steps", steps)
    internal = np.flatnonzero(~head) if want_lcp else np.zeros(0, np.int64)
    return (slots, out, slots[internal].astype(np.int64),
            lcp[internal].astype(np.int32))


def _tied(head: np.ndarray) -> np.ndarray:
    """bool mask of the rows whose segment (started by ``head``) holds
    two or more rows."""
    return ~head | np.r_[~head[1:], False]


def _be_bytes(x: np.ndarray) -> np.ndarray:
    """uint8[len(x), 8]: each value as a big-endian 64-bit word."""
    return x.astype(">u8").view(np.uint8).reshape(-1, 8)


@span("host: residue")
def apply_residue(sa, lcp, arr, patches, n: int, want_lcp: bool):
    """Resolve host residue groups and patch them into sa (and lcp).

    ``patches``: list of (slots int64[], idxs int32[], heads bool[],
    depth) per extraction (``resolve_residue_host``'s arguments).
    Returns (sa, lcp, n_patched)."""
    parts = [resolve_residue_host(arr, slots, idxs, n, want_lcp=want_lcp,
                                  heads=heads, depth=depth)
             for slots, idxs, heads, depth in patches if len(slots)]
    if not parts:
        return sa, lcp, 0
    slots, vals, lcp_slots, lcp_vals = (
        np.concatenate([p[j] for p in parts]) for j in range(4))
    sa = _patch(sa, slots, vals)
    if want_lcp and len(lcp_slots):
        lcp = _patch(lcp, lcp_slots, lcp_vals)
    return sa, lcp, len(slots)


def _patch(target: torch.Tensor, slots: np.ndarray,
           vals: np.ndarray) -> torch.Tensor:
    dev = target.device
    return apply_patch(target, torch.as_tensor(slots.astype(np.int64)).to(dev),
                       torch.as_tensor(vals.astype(np.int32)).to(dev))
