"""Packed initial ranks: the hand-written kernel and its plain version.

out[i] = sum_{j<h0} code(i+j) << bits*(h0-1-j), with
code(p) = remap[text[p]] for p < n_real and 0 past it.

``pack_ranks`` launches ``csrc/pack.cu`` for a CUDA tensor (the port of
``hpc_suffix_array_tpu/kernels/pack.py::pack_ranks_pallas``, fused with
the remap gather and mask around it) and runs ``pack_ranks_reference``
for a CPU tensor. There is no fallback between the two: a CUDA call
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.kernels import _build


def _check_args(text, remap, bits: int, h0: int, n_real: int) -> None:
    if text.dtype != torch.uint8 or text.dim() != 1:
        raise TypeError(f"text must be uint8[n], got {text.dtype} "
                        f"{tuple(text.shape)}")
    if remap.dtype != torch.int32 or tuple(remap.shape) != (256,):
        raise TypeError(f"remap must be int32[256], got {remap.dtype} "
                        f"{tuple(remap.shape)}")
    if text.device != remap.device:
        raise ValueError(f"text on {text.device}, remap on {remap.device}")
    if not (text.is_contiguous() and remap.is_contiguous()):
        raise ValueError("text and remap must be contiguous")
    if not 1 <= bits <= 9 or not 1 <= h0 or bits * h0 > 30:
        raise ValueError(f"need 1 <= bits <= 9, h0 >= 1 and bits*h0 <= 30; "
                         f"got bits={bits}, h0={h0}")
    if not 0 <= n_real <= text.shape[0]:
        raise ValueError(f"n_real={n_real} outside [0, {text.shape[0]}]")


def pack_ranks_reference(text: torch.Tensor, remap: torch.Tensor, bits: int,
                         h0: int, n_real: int) -> torch.Tensor:
    """Plain PyTorch fold (the JAX package's XLA fold,
    ``core/suffix_array.py::pack_ranks_kernel``): int32[n]."""
    _check_args(text, remap, bits, h0, n_real)
    n = text.shape[0]
    codes = remap[text.long()]              # int64 index: 8 B/position
    codes[n_real:] = 0
    ext = torch.cat([codes, codes.new_zeros(h0)])
    out = torch.zeros(n, dtype=torch.int32, device=text.device)
    for j in range(h0):
        out = (out << bits) | ext[j:j + n]
    return out


def pack_ranks(text: torch.Tensor, remap: torch.Tensor, bits: int, h0: int,
               n_real: int) -> torch.Tensor:
    """Packed initial ranks int32[n] of uint8 ``text`` (see module doc).

    On a CUDA tensor this launches the kernel on the current stream and
    adds one to ``pack_ranks.launches``; on a CPU tensor it returns
    ``pack_ranks_reference``."""
    _check_args(text, remap, bits, h0, n_real)
    if text.device.type == "cpu":
        return pack_ranks_reference(text, remap, bits, h0, n_real)
    if text.device.type != "cuda":
        raise ValueError(f"pack_ranks: unsupported device {text.device}")
    lib = _build.load()
    n = text.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=text.device)
    if n == 0:
        return out
    with torch.cuda.device(text.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_pack_ranks(text.data_ptr(), remap.data_ptr(),
                                out.data_ptr(), n, n_real, bits, h0, stream)
    _build.check(err, "sa_pack_ranks")
    pack_ranks.launches += 1
    return out


pack_ranks.launches = 0
