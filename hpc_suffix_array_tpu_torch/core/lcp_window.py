"""LCP array by adjacent-pair comparison: the window and sorted-fetch
routes, in PyTorch.

Counterpart of ``hpc_suffix_array_tpu/core/lcp_window.py``. Both routes
compute ``lcp[j] = LCP(suffix sa[j-1], suffix sa[j])`` directly, from
each suffix's first ``depth`` symbols:

  * window (``prepare_lcp``, ``build_lcp_array_window``): per chunk of
    ``CHUNK`` pairs, gather each suffix's ``depth`` bytes once (one int32
    word gather, realigned byte-wise), and take the first mismatch of
    each adjacent pair. ``depth`` follows the alphabet of the first
    4 MiB (``pick_depth``);
  * sorted fetch (``prepare_lcp_sorted``, ``build_lcp_array_sorted``):
    pack each suffix's first ``wn * spw`` codes into ``wn`` int32 words
    in text order with the pack kernel (K1, ``kernels/pack.py::
    pack_words``), bring them into SA order with one gather at ``sa``,
    and read the first mismatch of adjacent rows from xor and the
    highest set bit. The JAX package moves the words with two sorts
    instead, because a TPU gather costs about 10 ns per element.

Pairs that agree on the whole window (misses) are finished by
``_finish_misses``: the periodic-chain rule when the text is globally
d-periodic (``lcp[j] = n - sa[j-1]``, checked by a period sweep), else
an exact host comparison of at most ``HOST_FINISH_CAP`` pairs. Past the
cap the route raises ``NotImplementedError`` and the router
(``core/lcp.py``) falls back to PLCP.

Every entry point runs on ``device`` (the card unless the caller passes
``device="cpu"``); on the CPU, K1 runs its plain version.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.core.residue import (
    period_mismatches, suffix_lcp)
from hpc_suffix_array_tpu_torch.core.suffix_array import (
    alphabet_remap_dev, as_byte_array, device_text)
from hpc_suffix_array_tpu_torch.device import resolve_device
from hpc_suffix_array_tpu_torch.kernels.pack import pack_words
from hpc_suffix_array_tpu_torch.kernels.post_sort import _high_bit
from hpc_suffix_array_tpu_torch.utils.profiling import span

HOST_FINISH_CAP = 65536    # irregular window-miss pairs finished on host
CHUNK = 1 << 20
# Text bytes whose alphabet sets the window route's depth.
SIGMA_SAMPLE = 1 << 22
# K1 writes at most this many words in one launch.
K1_MAX_WORDS = 3


def pick_depth(n: int, sigma: int) -> int:
    """Window depth in bytes (multiple of 4): ~2 log_sigma n + slack."""
    if sigma < 2:
        return 64
    need = 2 * math.log(max(n, 2), sigma) + 10
    return int(min(64, max(16, 4 * math.ceil(need / 4))))


def _host_bytes(text) -> np.ndarray | None:
    """The host bytes of ``text``, or None for a tensor on a card: the
    host finish reads them back only if it runs."""
    if isinstance(text, torch.Tensor) and text.device.type != "cpu":
        return None
    return as_byte_array(text)


def _chain_fix(depth: int, sa: torch.Tensor, lcp: torch.Tensor, n: int,
               d: int):
    """lcp[j] = n - sa[j-1] for unresolved chain-neighbour pairs
    (sa[j-1] == sa[j] + d, d a verified global period). Returns (lcp,
    the count of pairs still unresolved, read once)."""
    prev = torch.cat([sa[:1], sa[:-1]])
    unresolved = lcp >= depth
    chain = unresolved & (prev - sa == d)
    lcp = torch.where(chain, n - prev, lcp)
    return lcp, int((unresolved & ~chain).sum())


def _unresolved_stats(depth: int, sa: torch.Tensor, lcp: torch.Tensor):
    """(count, dmax, dmin) over the unresolved pairs' deltas
    sa[j-1] - sa[j], read in one host read."""
    prev = torch.cat([sa[:1], sa[:-1]])
    unres = lcp >= depth
    unres[0] = False
    delta = prev - sa
    zero = torch.zeros((), dtype=delta.dtype, device=delta.device)
    dmax = torch.where(unres, delta, zero).max()
    dmin = torch.where(unres, delta, zero + (1 << 30)).min()
    cnt, dmax, dmin = torch.stack(
        [unres.sum(), dmax.long(), dmin.long()]).tolist()
    return cnt, dmax, dmin


def _refuse_past_cap(unresolved: int, depth: int) -> None:
    """NotImplementedError (the JAX package's message) when more than
    ``HOST_FINISH_CAP`` pairs are left for the host finish."""
    if unresolved > HOST_FINISH_CAP:
        raise NotImplementedError(
            f"{unresolved} adjacent pairs exceed the {depth}-byte "
            "window and are not a global period - use the PLCP path "
            "(raise SA_LCP_WINDOW_MIN) or the sharded LCP builder")


def _finish_misses(arr: np.ndarray | None, text_dev: torch.Tensor,
                   sa: torch.Tensor, lcp: torch.Tensor, depth: int, n: int,
                   info: dict | None = None) -> torch.Tensor:
    """Resolve the window misses (lcp >= depth): the chain rule, then
    the host finish of at most ``HOST_FINISH_CAP`` irregular pairs.

    Shared tail of both routes. ``text_dev``: the text on the device (at
    least n bytes) for the period sweep; ``arr``: its host bytes, or
    None to read them back when the host finish runs. ``info`` receives
    ``lcp_misses`` and ``lcp_finish`` ("none", "chain" or "host")."""
    total_miss = int((lcp[1:] >= depth).sum())          # one host read
    if info is not None:
        info["lcp_misses"] = total_miss
        info["lcp_finish"] = "none"
    if total_miss == 0:
        return lcp

    # The periodic-chain rule, decided from scalars.
    cnt, dmax, dmin = _unresolved_stats(depth, sa, lcp)
    d = dmax if (cnt and dmax == dmin and dmax > 0) else 0
    chained = False
    if d > 0 and period_mismatches(text_dev, d, n) == 0:
        lcp, residual = _chain_fix(depth, sa, lcp, n, d)
        if residual == 0:
            if info is not None:
                info["lcp_finish"] = "chain"
            return lcp
        chained = True

    # The irregular residue: one bulk read, then an exact host finish.
    # Without a chain fix every miss stays unresolved, so a refusal needs
    # no bulk read.
    if not chained:
        _refuse_past_cap(total_miss, depth)
    lcp_np = lcp.cpu().numpy().copy()
    sa_np = sa.cpu().numpy()
    prev_np = np.concatenate([sa_np[:1], sa_np])[:-1]
    unresolved_idx = np.flatnonzero(lcp_np >= depth)
    unresolved_idx = unresolved_idx[unresolved_idx > 0]
    _refuse_past_cap(len(unresolved_idx), depth)
    if arr is None:
        arr = text_dev[:n].cpu().numpy()
    for j in unresolved_idx:
        lcp_np[j] = suffix_lcp(arr, int(prev_np[j]), int(sa_np[j]), n)
    if info is not None:
        info["lcp_finish"] = "host"
    return torch.from_numpy(lcp_np).to(lcp.device)


# --- the window route -------------------------------------------------------

def _sym_windows(text32: torch.Tensor, idx: torch.Tensor, depth: int
                 ) -> torch.Tensor:
    """uint8[P, depth]: the ``depth`` bytes from each position of
    ``idx``, by one gather of depth//4 + 1 int32 words per position and
    a realignment by ``idx & 3`` (4 static byte shifts). Bytes past the
    text are the zero padding."""
    nw = depth // 4 + 1
    base = (idx >> 2).long()
    words = text32[base[:, None] + torch.arange(nw, device=idx.device)]
    bytes_ = words.view(torch.uint8)                 # (P, 4*nw), LE order
    off = (idx & 3)[:, None]
    mat = bytes_[:, 3:3 + depth]
    for o in (2, 1, 0):
        mat = torch.where(off == o, bytes_[:, o:o + depth], mat)
    return mat


def _lcp_chunk(depth: int, text32: torch.Tensor, idx: torch.Tensor,
               n: int) -> torch.Tensor:
    """First-mismatch offsets int32[P] of the pairs (idx[p], idx[p+1])
    over ``depth`` symbols (byte + 1, 0 past n); ``depth`` where the
    window holds no mismatch.

    Two distinct suffixes of lengths la != lb first differ at the first
    differing byte below min(la, lb), or at min(la, lb), where the
    shorter one ends."""
    mat = _sym_windows(text32, idx, depth)
    neq = mat[:-1] != mat[1:]
    first = neq.to(torch.uint8).argmax(dim=1)
    first = torch.where(neq.any(dim=1), first, depth)
    ends = n - torch.maximum(idx[:-1], idx[1:])
    return torch.minimum(first, ends.long()).to(torch.int32)


def prepare_lcp(text, *, device="cuda",
                text_dev: torch.Tensor | None = None) -> dict:
    """Stage the text for repeated window-LCP runs.

    ``text_dev``: optional uint8 copy of the same bytes on ``device`` (at
    least n long; see ``device_text``), used instead of staging
    ``text``. The state holds a zero-padded device copy and its int32
    view."""
    dev = resolve_device(device)
    t = device_text(text, dev, text_dev)
    n = int(t.shape[0])
    head = t[:SIGMA_SAMPLE].long()
    sigma = int((torch.bincount(head, minlength=256) > 0).sum()) if n else 0
    depth = pick_depth(n, sigma)
    nbytes = -(-(n + depth + 8) // 4) * 4
    pad = torch.zeros(nbytes, dtype=torch.uint8, device=dev)
    pad[:n] = t
    return {"arr": _host_bytes(text), "n": n, "depth": depth,
            "text_dev": pad, "text32": pad.view(torch.int32)}


@span("lcp: window")
def build_lcp_array_window(text, sa, state: dict | None = None, *,
                           device="cuda", text_dev=None,
                           info: dict | None = None) -> torch.Tensor:
    """LCP array int32[n] by the window route (see the module doc).

    ``state``: from ``prepare_lcp`` (else prepared here from ``text``,
    ``device`` and ``text_dev``). ``info`` as in ``_finish_misses``.
    Raises NotImplementedError when more than ``HOST_FINISH_CAP``
    irregular pairs miss the window."""
    if state is None:
        state = prepare_lcp(text, device=device, text_dev=text_dev)
    n, depth, text32 = state["n"], state["depth"], state["text32"]
    dev = text32.device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    sa = torch.as_tensor(sa).to(device=dev, dtype=torch.int32)
    sa_ext = torch.cat([sa[:1], sa])
    lcp = torch.cat([_lcp_chunk(depth, text32, sa_ext[s:s + CHUNK + 1], n)
                     for s in range(0, n, CHUNK)])
    lcp[0] = 0
    return _finish_misses(state["arr"], state["text_dev"], sa, lcp, depth,
                          n, info)


# --- the sorted-fetch route -------------------------------------------------

def _pick_wn(n: int, sigma: int, spw: int) -> int:
    """Number of packed key words so expected adjacent-pair misses stay
    in the host-finish regime: sigma^(WN*spw) >> n^2 (misses ~ number of
    repeated (WN*spw)-grams). Periodic texts miss regardless and take
    the chain rule instead."""
    lg_sigma = math.log2(max(sigma, 2))
    need_syms = (2 * math.log2(max(n, 2)) + 10) / lg_sigma
    return int(min(4, max(2, math.ceil(need_syms / max(spw, 1)))))


def prepare_lcp_sorted(text, text_pad_dev: torch.Tensor | None = None, *,
                       device="cuda") -> dict:
    """Stage the text for repeated sorted-fetch LCP runs.

    ``text_pad_dev``: optional uint8 copy of the text on ``device``
    whose first n bytes are the text (any padding after them is never
    read: K1 codes positions past n as 0), used instead of staging
    ``text``. The alphabet is counted on the device; ``bits``, ``spw``
    and the codes 1..sigma are the port's alphabet remap, as in the JAX
    package."""
    dev = resolve_device(device)
    t = device_text(text, dev, text_pad_dev)
    n = int(t.shape[0])
    if n:
        remap, bits, _ = alphabet_remap_dev(t)
    else:
        remap, bits = np.zeros(256, np.int32), 1
    sigma = int(remap.max()) if n else 1
    spw = max(1, 30 // bits)
    return {"arr": _host_bytes(text), "n": n, "spw": spw, "bits": bits,
            "wn": _pick_wn(n, sigma, spw), "text_dev": t,
            "table": torch.as_tensor(remap, dtype=torch.int32).to(dev)}


def sorted_words(state: dict) -> list[torch.Tensor]:
    """The ``wn`` key words int32[n] of every suffix in text order: word
    w packs the codes from i + w*spw, 0 past n. K1 writes up to three
    words in one launch, so wn = 4 takes a second launch at word
    offset 3*spw."""
    t, n, spw = state["text_dev"], state["n"], state["spw"]
    wn, bits, table = state["wn"], state["bits"], state["table"]
    words = []
    for w0 in range(0, wn, K1_MAX_WORDS):
        words += pack_words(t, table, bits, spw, n,
                            min(K1_MAX_WORDS, wn - w0), offset=w0 * spw,
                            n_out=n)
    return words


def _mismatch_sorted(state: dict, sa: torch.Tensor) -> torch.Tensor:
    """First-mismatch offsets int32[n] of adjacent SA pairs over
    ``wn*spw`` symbols; ``wn*spw`` where they agree on all of them;
    entry 0 reads 0.

    Each word is gathered into SA order (``index_select`` at the int32
    ``sa``) and dropped in text order before the next; a pair's first
    differing symbol in word w is spw-1 - highest_bit(xor) // bits, and
    the first differing word wins."""
    spw, bits = state["spw"], state["bits"]
    depth = state["wn"] * spw
    words = sorted_words(state)
    lcp = torch.full_like(sa, depth)
    for w in reversed(range(len(words))):
        kw = torch.index_select(words.pop(), 0, sa)
        x = torch.cat([kw[:1], kw[:-1]]) ^ kw
        del kw
        sym = spw - 1 - torch.div(_high_bit(x), bits, rounding_mode="floor")
        lcp = torch.where(x != 0, w * spw + sym, lcp)
    lcp[0] = 0
    return lcp


@span("lcp: sorted_fetch")
def build_lcp_array_sorted(text, sa, state: dict | None = None, *,
                           device="cuda", text_pad_dev=None,
                           info: dict | None = None) -> torch.Tensor:
    """LCP array int32[n] by the sorted-fetch route (see the module doc).

    ``state``: from ``prepare_lcp_sorted`` (else prepared here from
    ``text``, ``text_pad_dev`` and ``device``). ``info`` as in
    ``_finish_misses``. Raises NotImplementedError when more than
    ``HOST_FINISH_CAP`` irregular pairs miss the window."""
    if state is None:
        state = prepare_lcp_sorted(text, text_pad_dev, device=device)
    n, t = state["n"], state["text_dev"]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=t.device)
    sa = torch.as_tensor(sa).to(device=t.device, dtype=torch.int32)
    lcp = _mismatch_sorted(state, sa)
    return _finish_misses(state["arr"], t, sa, lcp,
                          state["wn"] * state["spw"], n, info)
