"""LCP array by data-parallel PLCP rounds, in PyTorch.

Counterpart of the PLCP route of ``hpc_suffix_array_tpu/core/lcp.py``
(``_plcp_setup``, ``_plcp_round``, ``plcp_kernel``, ``lcp_from_plcp``).
PLCP is the LCP indexed by text position; every value is a verified
lower bound, improved each round by three steps:

  1. monotone propagation: plcp[i] + i is non-decreasing, so a running
     max (``torch.cummax``) carries strong bounds forward;
  2. pointer jumping: where the partner chain is aligned,
     plcp[i] = cur + plcp[i + cur], so bounds compose;
  3. verified extension: each unresolved position compares the next
     ``CMP_WIDTH`` bytes of its suffix and its SA predecessor's.

The loop is host-driven (one ``resolved.all()`` sync per round), as in
the JAX package, and bounded by ``PLCP_ROUNDS``: past it host Kasai
closes the LCP (``lcp_path`` "plcp_kasai"). The JAX package runs up to
n / CMP_WIDTH rounds, which a long verbatim copy can take.

The router follows the JAX package's ``build_lcp_array``:

  * above ``SA_LCP_BIG_MIN``, and for texts of deep repeats between
    ``SA_LCP_CHAIN_MIN`` and ``SA_LCP_WINDOW_MIN``, the LCP of a
    carried-keys build (``_sa_lcp_big``: the direct or MSD builder's
    sorted keys, ``core/bigsort.py``, ``want_lcp``);
  * above ``SA_LCP_WINDOW_MIN``, when no carried-keys build derived it,
    the sorted-fetch route (``core/lcp_window.py``), or the window route
    under ``SA_LCP_FETCH=window``;
  * PLCP otherwise, and where the window routes refuse a text (too many
    irregular misses) at any n. The JAX package re-raises that refusal
    above ``SA_LCP_PLCP_MAX``, a TPU compile limit the port does not
    have.

Past the doubling reach, where no carried-keys build derived the LCP
and the window routes refused, host Kasai on the supplied SA closes it
(``lcp_path`` "kasai_host"), as host SA-IS and Kasai close
``build_sa_lcp``: PLCP's int32 positions stop at ``PLCP_MAX``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hpc_suffix_array_tpu_torch.core.suffix_array import (
    alphabet_remap_dev, as_byte_array, build_suffix_array,
    build_suffix_array_doubling, carried_keys_build, device_text,
    doubling_reach, sais_host_fallback)
from hpc_suffix_array_tpu_torch.device import resolve_device
from hpc_suffix_array_tpu_torch.utils.profiling import record, span

# Bytes compared per unresolved position per round.
CMP_WIDTH = 32
# Positions per extension chunk. The (chunk, CMP_WIDTH) compare holds
# int32 positions and int64 gather indices, about 24 B per cell, so
# 2^22 positions bound the temporaries to about 3 GiB; unchunked, the
# same compare at 2^28 would need about 200 GB.
CHUNK = 1 << 22
# Pointer-jumping steps per round (each approximately doubles verified runs).
JUMP_STEPS = 2
# Rounds PLCP runs before host Kasai closes the LCP instead. Propagation
# and jumping resolve most texts in 1-5 rounds, but long verbatim copies
# can advance by about CMP_WIDTH bytes a round: unbounded, PLCP took 54 s
# a build on 1 GiB English with copies of 64 KiB-1 MiB, and one seed did
# not end in 240 s (PERF.md).
PLCP_ROUNDS = 4096 // CMP_WIDTH
# Largest n PLCP takes: the extension's int32 positions (iota + cur +
# offs, up to n - 1 + CMP_WIDTH) must not wrap.
PLCP_MAX = (1 << 31) - 1 - CMP_WIDTH


# Route thresholds of the JAX package (bytes; set on a TPU), read from
# the same environment names.
def lcp_big_min() -> int:
    """Above this (``SA_LCP_BIG_MIN``, 8 MiB): the fused carried-keys
    SA+LCP build."""
    return int(os.environ.get("SA_LCP_BIG_MIN", 1 << 23))


def lcp_window_min() -> int:
    """Above this (``SA_LCP_WINDOW_MIN``, 4 MiB): the sorted-fetch or
    window route."""
    return int(os.environ.get("SA_LCP_WINDOW_MIN", 1 << 22))


def lcp_fetch() -> str:
    """``SA_LCP_FETCH``: "window" picks the window route, anything else
    (default "sorted") the sorted-fetch route."""
    return ("window" if os.environ.get("SA_LCP_FETCH", "sorted") == "window"
            else "sorted")


def lcp_chain_min() -> int:
    """From this size (``SA_LCP_CHAIN_MIN``, 16 KiB) deep-repeat texts
    take the carried-keys build."""
    return int(os.environ.get("SA_LCP_CHAIN_MIN", 1 << 14))


def lcp_chain_est() -> int:
    """Repeat estimate (``SA_LCP_CHAIN_EST``, 512 bytes) beyond which a
    text counts as deep-repeat."""
    return int(os.environ.get("SA_LCP_CHAIN_EST", 512))


def _plcp_setup(sa: torch.Tensor):
    """phi[i] = SA-predecessor of suffix i (-1 for the SA head) and the
    upper bound limit[i] = n - max(i, phi[i]) (0 where phi is -1)."""
    n = sa.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=sa.device)
    sa_l = sa.long()                    # int64 index: 8 B/position
    isa = torch.empty(n, dtype=torch.int32, device=sa.device)
    isa[sa_l] = iota
    phi = torch.where(isa > 0, sa[(isa - 1).clamp_(min=0).long()],
                      torch.tensor(-1, dtype=torch.int32, device=sa.device))
    limit = torch.where(phi >= 0, n - torch.maximum(iota, phi),
                        torch.zeros_like(phi))
    return phi, limit, iota


def _extend_chunk(text, n: int, cur, phi, iota, act):
    """Matching-byte counts (0..CMP_WIDTH) at each chunk position's
    current offset; inactive positions count 0."""
    offs = torch.arange(CMP_WIDTH, dtype=torch.int32, device=text.device)
    a_pos = (iota + cur)[:, None] + offs
    b_pos = (phi + cur)[:, None] + offs
    ok = (a_pos < n) & (b_pos < n) & (b_pos >= 0) & act[:, None]
    ta = text[a_pos.clamp_(0, n - 1).long()]
    tb = text[b_pos.clamp_(0, n - 1).long()]
    miss = (ta != tb) | ~ok
    # Leading matches = index of the first miss (argmax returns the first
    # maximum), or CMP_WIDTH when the row has none. The JAX package's
    # cumprod-then-sum gives the same count, but torch's row-wise cumprod
    # was most of the LCP phase's device time on the H100.
    first_miss = miss.to(torch.uint8).argmax(dim=1).to(torch.int32)
    return torch.where(miss.any(dim=1), first_miss,
                       torch.full_like(first_miss, CMP_WIDTH))


def _plcp_round(text, phi, limit, iota, cur, resolved):
    """One propagate + jump + extend round; updates cur and resolved in
    place and returns whether every position is resolved."""
    n = text.shape[0]
    # 1) monotone propagation (plcp[i]+i non-decreasing).
    runmax = torch.cummax(cur + iota, 0).values
    prop = torch.minimum(torch.maximum(cur, runmax - iota).clamp_(min=0),
                         limit)
    cur.copy_(torch.where(resolved, cur, prop))
    resolved |= cur >= limit

    # 2) pointer jumping along the aligned phi chain.
    for _ in range(JUMP_STEPS):
        ahead = iota + cur
        tgt = ahead.clamp(max=n - 1).long()
        aligned = ~resolved & (ahead < n) & (phi[tgt] == phi + cur)
        bumped = torch.minimum(cur + cur[tgt], limit)
        now_exact = aligned & resolved[tgt]
        cur.copy_(torch.where(aligned, bumped, cur))
        resolved |= now_exact | (cur >= limit)

    # 3) verified extension by direct byte comparison, chunked.
    for s in range(0, n, CHUNK):
        e = min(s + CHUNK, n)
        act = ~resolved[s:e]
        m = _extend_chunk(text, n, cur[s:e], phi[s:e], iota[s:e], act)
        cur[s:e] += m
        resolved[s:e] |= act & (m < CMP_WIDTH)
    return bool(resolved.all())


def plcp_kernel(text: torch.Tensor, sa: torch.Tensor):
    """(plcp int32[n], rounds): plcp[i] = LCP(suffix i, its SA predecessor).

    ``plcp`` is None where ``PLCP_ROUNDS`` rounds left a position
    unresolved (the caller closes the LCP another way). Raises
    ValueError above ``PLCP_MAX`` positions."""
    n = text.shape[0]
    if n > PLCP_MAX:
        raise ValueError(f"PLCP takes at most {PLCP_MAX} positions (int32 "
                         f"positions), got {n}")
    phi, limit, iota = _plcp_setup(sa)
    cur = torch.zeros(n, dtype=torch.int32, device=text.device)
    resolved = phi < 0
    # Host-driven convergence, typically 1-5 rounds.
    for rounds in range(1, PLCP_ROUNDS + 1):
        if _plcp_round(text, phi, limit, iota, cur, resolved):
            return cur, rounds
    return None, PLCP_ROUNDS


def lcp_from_plcp(plcp: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """Permute plcp into SA order; lcp[0] = 0."""
    lcp = plcp[sa.long()]
    if lcp.shape[0]:
        lcp[0] = 0
    return lcp


def _sa_lcp_big(text, n: int, *, device, text_dev=None,
                info: dict | None = None):
    """(sa, lcp) from the carried-keys builds (direct when preferred,
    else MSD; ``carried_keys_build``), or None when both decline (the
    caller then takes doubling and PLCP, or host SA-IS and Kasai past
    the doubling reach).

    ``text``: the host bytes (planning); ``text_dev``: their device copy,
    whose alphabet is counted on the device. ``info`` receives the
    build's keys and ``path`` ("direct" or "msd"), or ``declined``."""
    from hpc_suffix_array_tpu_torch.core.bigsort import estimate_repeat_len

    host = as_byte_array(text)
    t = device_text(host, device, text_dev)
    remap, _, _ = alphabet_remap_dev(t)
    return carried_keys_build(host, n, t, remap, estimate_repeat_len(host),
                              info, want_lcp=True)


def _plcp_lcp(text, t: torch.Tensor, sa: torch.Tensor,
              info: dict | None) -> torch.Tensor:
    """PLCP, or host Kasai where PLCP stops at its round bound
    (``lcp_path`` "plcp_kasai")."""
    with span("plcp"):
        plcp, rounds = plcp_kernel(t, sa)
    if info is not None:
        info["plcp_rounds"] = rounds
    if plcp is None:
        if info is not None:
            info["lcp_path"] = "plcp_kasai"
        return _kasai_host(as_byte_array(text), sa, t.device)
    return lcp_from_plcp(plcp, sa)


def _sais_kasai(text, dev: torch.device, info: dict | None):
    """(sa, lcp) from host SA-IS and Kasai (native C, O(n)), on ``dev``."""
    host = as_byte_array(text)
    sa = sais_host_fallback(host, device="cpu", info=info)
    return sa.to(dev), _kasai_host(host, sa, dev)


def _kasai_host(host: np.ndarray, sa: torch.Tensor,
                dev: torch.device) -> torch.Tensor:
    """LCP of ``sa`` by host Kasai (native C, O(n)), on ``dev``."""
    from hpc_suffix_array_tpu_torch import native

    with span("kasai: host"):
        lcp = native.lcp_kasai(host, sa.cpu().numpy())
    return torch.from_numpy(lcp).to(dev)


def _fetch_lcp(text, t: torch.Tensor, sa: torch.Tensor,
               info: dict | None):
    """The sorted-fetch or window route (``lcp_fetch``), or None when it
    refuses the text; ``info`` receives ``lcp_path``, ``lcp_misses`` and
    ``lcp_finish``, or ``lcp_declined``."""
    from hpc_suffix_array_tpu_torch.core import lcp_window

    route = lcp_fetch()
    fetch = {}
    try:
        if route == "window":
            lcp = lcp_window.build_lcp_array_window(
                text, sa, device=t.device, text_dev=t, info=fetch)
        else:
            lcp = lcp_window.build_lcp_array_sorted(
                text, sa, device=t.device, text_pad_dev=t, info=fetch)
    except NotImplementedError as e:
        if info is not None:
            info["lcp_declined"] = str(e)
        return None
    if info is not None:
        info.update(fetch, lcp_path=route)
    return lcp


def _lcp_of_sa(text, t: torch.Tensor, sa: torch.Tensor,
               info: dict | None) -> torch.Tensor:
    """The LCP of ``sa`` where no carried-keys build derived it: the
    sorted-fetch or window route above ``SA_LCP_WINDOW_MIN``; where that
    refuses or below it, PLCP, or host Kasai past the doubling reach."""
    n = t.shape[0]
    if n > lcp_window_min():
        lcp = _fetch_lcp(text, t, sa, info)
        if lcp is not None:
            return lcp
    if n > doubling_reach():
        if info is not None:
            info["lcp_path"] = "kasai_host"
        return _kasai_host(as_byte_array(text), sa, t.device)
    if info is not None:
        info["lcp_path"] = "plcp"
    return _plcp_lcp(text, t, sa, info)


def build_sa_lcp(text, *, device, info: dict | None = None,
                 text_dev: torch.Tensor | None = None):
    """Fused (suffix array, LCP array) build, int32[n] each.

    Above ``SA_LCP_BIG_MIN`` this is one carried-keys pass; when that
    declines, the doubling builder runs directly (no second carried-keys
    attempt) and the LCP takes ``build_lcp_array``'s other routes (the
    sorted-fetch or window route, else PLCP) up to ``DOUBLING_REACH``;
    host SA-IS and Kasai above it. Below it, ``build_suffix_array`` and
    ``build_lcp_array`` run back to back. ``text_dev`` and ``info`` as
    in ``build_suffix_array``, plus ``build_lcp_array``'s ``lcp_*``
    keys on the decline path (top span "sa_lcp")."""
    with record("sa_lcp", info):
        return _build_sa_lcp(text, device, info, text_dev)


def _build_sa_lcp(text, device, info: dict | None,
                  text_dev: torch.Tensor | None):
    dev = resolve_device(device)
    t = device_text(text, dev, text_dev)
    n = t.shape[0]
    if n > lcp_big_min():
        derived = _sa_lcp_big(text, n, device=dev, text_dev=t, info=info)
        if derived is not None:
            return derived
        if n > doubling_reach():
            return _sais_kasai(text, dev, info)
        sa = build_suffix_array_doubling(t, device=dev, info=info)
        return sa, _lcp_of_sa(text, t, sa, info)
    sa = build_suffix_array(text, device=dev, info=info, text_dev=t)
    return sa, build_lcp_array(text, sa, device=dev, info=info, text_dev=t)


def _deep_repeat(arr: np.ndarray) -> bool:
    """Longest-repeat estimate beyond what the PLCP rounds absorb
    cheaply (``SA_LCP_CHAIN_EST``)."""
    from hpc_suffix_array_tpu_torch.core.bigsort import estimate_repeat_len

    return estimate_repeat_len(arr) > lcp_chain_est()


def build_lcp_array(text, sa, *, device, info: dict | None = None,
                    text_dev: torch.Tensor | None = None) -> torch.Tensor:
    """LCP array int32[n]: lcp[j] = LCP(suffix sa[j-1], suffix sa[j]),
    lcp[0] = 0, built on ``device``. ``sa`` must be the suffix array of
    ``text``.

    Above ``SA_LCP_BIG_MIN``, and for deep-repeat texts from
    ``SA_LCP_CHAIN_MIN`` to ``SA_LCP_WINDOW_MIN``, the LCP comes from a
    carried-keys build (direct or MSD), which derives the order from the
    text itself: the supplied ``sa`` is then checked against the derived
    one, and a mismatch raises ValueError. Otherwise, and when that build
    declines, the routes of ``_lcp_of_sa``: above ``SA_LCP_WINDOW_MIN``
    the sorted-fetch route (``SA_LCP_FETCH=window``: the window route),
    and where it refuses or below it PLCP up to the doubling reach and
    host Kasai on ``sa`` past it. ``text_dev`` as in
    ``build_suffix_array``.
    ``info``: optional dict that receives ``lcp_path`` ("direct", "msd",
    "sorted", "window", "plcp", "plcp_kasai" (PLCP stopped at its round
    bound, host Kasai closed) or "kasai_host"); for the sorted-fetch and
    window routes ``lcp_misses`` (pairs past the window) and
    ``lcp_finish`` ("none", "chain" or "host"); ``lcp_declined`` (why
    they refused); for PLCP, ``plcp_rounds``; and the build record's keys
    as in ``build_suffix_array`` (top span "lcp")."""
    with record("lcp", info):
        return _build_lcp_array(text, sa, device, info, text_dev)


def _build_lcp_array(text, sa, device, info: dict | None,
                     text_dev: torch.Tensor | None) -> torch.Tensor:
    dev = resolve_device(device)
    t = device_text(text, dev, text_dev)
    n = t.shape[0]
    sa = torch.as_tensor(sa).to(device=dev, dtype=torch.int32)
    if sa.shape[0] != n:
        raise ValueError(f"sa length {sa.shape[0]} != text length {n}")
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    derived, what, route = None, "", {}
    if n > lcp_big_min():
        derived = _sa_lcp_big(text, n, device=dev, text_dev=t, info=route)
        what = "large-text"
    elif lcp_chain_min() <= n <= lcp_window_min():
        host = as_byte_array(text)
        if _deep_repeat(host):
            derived = _sa_lcp_big(host, n, device=dev, text_dev=t,
                                  info=route)
            what = "repetitive-text"
    if derived is not None:
        derived_sa, lcp = derived
        if not torch.equal(derived_sa, sa):
            raise ValueError(
                f"supplied sa is not the suffix array of text: the {what} "
                "LCP route derives the order from the text (carried-keys "
                "build) and cross-checks `sa`; pass the true SA or call "
                "build_sa_lcp(text)")
        if info is not None:
            info["lcp_path"] = route["path"]
        return lcp
    return _lcp_of_sa(text, t, sa, info)
