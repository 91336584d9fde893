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
the JAX package. ``build_lcp_array`` takes this route at every n; the
JAX package's window, sorted-fetch and carried-keys LCP routes are not
ported yet.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.core.suffix_array import as_byte_tensor
from hpc_suffix_array_tpu_torch.device import resolve_device

# Bytes compared per unresolved position per round.
CMP_WIDTH = 32
# Positions per extension chunk. The (chunk, CMP_WIDTH) compare holds
# int32 positions and int64 gather indices, about 24 B per cell, so
# 2^22 positions bound the temporaries to about 3 GiB; unchunked, the
# same compare at 2^28 would need about 200 GB.
CHUNK = 1 << 22
# Pointer-jumping steps per round (each approximately doubles verified runs).
JUMP_STEPS = 2


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
    """(plcp int32[n], rounds): plcp[i] = LCP(suffix i, its SA predecessor)."""
    n = text.shape[0]
    phi, limit, iota = _plcp_setup(sa)
    cur = torch.zeros(n, dtype=torch.int32, device=text.device)
    resolved = phi < 0
    rounds = 0
    # Host-driven convergence: bounded by n/CMP_WIDTH, typically 1-5 rounds.
    for _ in range(n // CMP_WIDTH + 2):
        rounds += 1
        if _plcp_round(text, phi, limit, iota, cur, resolved):
            break
    return cur, rounds


def lcp_from_plcp(plcp: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """Permute plcp into SA order; lcp[0] = 0."""
    lcp = plcp[sa.long()]
    if lcp.shape[0]:
        lcp[0] = 0
    return lcp


def build_lcp_array(text, sa, *, device, info: dict | None = None
                    ) -> torch.Tensor:
    """LCP array int32[n]: lcp[j] = LCP(suffix sa[j-1], suffix sa[j]),
    lcp[0] = 0, built on ``device``. ``sa`` must be the suffix array of
    ``text``. ``info``: optional dict that receives ``plcp_rounds``."""
    dev = resolve_device(device)
    t = as_byte_tensor(text, dev)
    n = t.shape[0]
    sa = torch.as_tensor(sa).to(device=dev, dtype=torch.int32)
    if sa.shape[0] != n:
        raise ValueError(f"sa length {sa.shape[0]} != text length {n}")
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    plcp, rounds = plcp_kernel(t, sa)
    if info is not None:
        info["plcp_rounds"] = rounds
    return lcp_from_plcp(plcp, sa)
