"""Packed key words (K1): the hand-written kernel and its plain version.

Word w of row i folds the spw codes from i + offset + w*spw:

  word_w[i] = sum_{j<spw} code(i+offset+w*spw+j) << bits*(spw-1-j),
  code(p) = table[text[p]] for p < n_real and 0 past it.

``offset`` 0 and one word give the doubling builder's initial ranks
(``pack_ranks``, h0 = spw); words 0..nw-1 are the carried-keys builders'
key words (the JAX package's ``core/bigsort.py::_direct_keys`` and
``_dev_pack_word``, XLA folds at a word offset); two words into the
columns of one (rows, 2) table are the refinement's pair table.

Precondition: every table entry is below 2^bits (every table the port
builds is: codes 0..sigma with sigma < 2^bits). The kernel's rolling
fold keeps the last spw codes by a mask, which equals the sum above only
then; ``_check_args`` enforces bits*spw <= 30.

``pack_words`` and ``pack_ranks`` launch ``csrc/pack.cu`` (the port of
``hpc_suffix_array_tpu/kernels/pack.py::pack_ranks_pallas``, fused with
the remap gather and mask around it) for a CUDA tensor, and run
``pack_words_reference`` / ``pack_ranks_reference`` for a CPU tensor.
There is no fallback between the two: a CUDA call launches the kernel
or raises. Each entry point counts its launches ("launches: <name>", on
CUDA) and, on either device, the bytes the call must move ("k1_bytes":
the text bytes its rows' windows cover below ``n_real``, read once,
and 4 B a word a row written) in the recorder of ``utils/profiling.py``.
"""

from __future__ import annotations

import torch

from hpc_suffix_array_tpu_torch.kernels import _build
from hpc_suffix_array_tpu_torch.utils.profiling import count


def _check_args(text, remap, bits: int, h0: int, n_real: int,
                offset: int, n_words: int = 1, n_out: int = 0) -> None:
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
    if offset < 0:
        raise ValueError(f"offset={offset} must be >= 0")
    if not 1 <= n_words <= 3:
        raise ValueError(f"n_words={n_words} outside [1, 3]")
    if n_out < 0:
        raise ValueError(f"n_out={n_out} must be >= 0")


def _check_out(out, n_words: int, n_out: int, device) -> list:
    """``out``: n_words int32 tensors of n_out rows with one element
    stride (contiguous, or the columns of a row-major table)."""
    out = list(out)
    if len(out) != n_words:
        raise ValueError(f"out has {len(out)} tensors, need {n_words}")
    for o in out:
        if (o.dtype != torch.int32 or o.dim() != 1 or o.shape[0] != n_out
                or o.device != device):
            raise TypeError(f"out tensors must be int32[{n_out}] on "
                            f"{device}, got {o.dtype} {tuple(o.shape)} on "
                            f"{o.device}")
        if o.stride(0) != out[0].stride(0) or o.stride(0) < 1:
            raise ValueError("out tensors need one positive element stride")
    return out


def pack_ranks_reference(text: torch.Tensor, remap: torch.Tensor, bits: int,
                         h0: int, n_real: int, offset: int = 0
                         ) -> torch.Tensor:
    """Plain PyTorch fold (the JAX package's XLA folds,
    ``core/suffix_array.py::pack_ranks_kernel`` and
    ``core/bigsort.py::_dev_pack_word``): int32[n]."""
    _check_args(text, remap, bits, h0, n_real, offset)
    n = text.shape[0]
    codes = remap[text.long()]              # int64 index: 8 B/position
    codes[n_real:] = 0
    ext = torch.cat([codes, codes.new_zeros(offset + h0)])
    out = torch.zeros(n, dtype=torch.int32, device=text.device)
    for j in range(offset, offset + h0):
        out = (out << bits) | ext[j:j + n]
    return out


def pack_words_reference(text: torch.Tensor, table: torch.Tensor, bits: int,
                         spw: int, n_real: int, n_words: int,
                         offset: int = 0, n_out: int | None = None,
                         out=None) -> list[torch.Tensor]:
    """Plain version of ``pack_words``: ``pack_ranks_reference`` per
    word on the text from ``offset``, written into the same layout."""
    n_out = text.shape[0] if n_out is None else int(n_out)
    _check_args(text, table, bits, spw, n_real, offset, n_words, n_out)
    seg = text[offset:offset + n_out + n_words * spw]
    real = min(max(n_real - offset, 0), seg.shape[0])
    if seg.shape[0] < n_out:
        seg = torch.cat([seg, seg.new_zeros(n_out - seg.shape[0])])
    words = [pack_ranks_reference(seg, table, bits, spw, real,
                                  w * spw)[:n_out]
             for w in range(n_words)]
    if out is None:
        return words
    out = _check_out(out, n_words, n_out, text.device)
    for o, w in zip(out, words):
        o.copy_(w)
    return out


def k1_bytes(n_real: int, offset: int, n_out: int, n_words: int,
             spw: int) -> int:
    """Bytes a fold of ``n_out`` rows from ``offset`` must move: the text
    bytes below ``n_real`` that the rows' windows of ``n_words * spw``
    symbols cover, each read once, and every word written once."""
    read = max(0, min(n_real, offset + n_out + n_words * spw - 1) - offset)
    return read + 4 * n_out * n_words


def _launch(text, table, bits, spw, n_real, n_words, offset, n_out,
            out) -> list[torch.Tensor]:
    """One K1 launch on the current stream (arguments checked)."""
    if text.device.type != "cuda":
        raise ValueError(f"pack kernel: unsupported device {text.device}")
    if out is None:
        out = [torch.empty(n_out, dtype=torch.int32, device=text.device)
               for _ in range(n_words)]
    else:
        out = _check_out(out, n_words, n_out, text.device)
    if n_out == 0:
        return out
    lib = _build.load()
    ptrs = [o.data_ptr() for o in out] + [0] * (3 - n_words)
    with torch.cuda.device(text.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_pack_words(text.data_ptr(), table.data_ptr(), *ptrs,
                                out[0].stride(0), n_out, n_real, offset,
                                bits, spw, n_words, stream)
    _build.check(err, "sa_pack_words")
    return out


def pack_words(text: torch.Tensor, table: torch.Tensor, bits: int, spw: int,
               n_real: int, n_words: int, offset: int = 0,
               n_out: int | None = None, out=None) -> list[torch.Tensor]:
    """``n_words`` (1-3) packed words of ``n_out`` rows (default: the
    text's length) of uint8 ``text`` (see module doc), in one launch that
    reads the text once.

    Returns a list of contiguous int32[n_out] tensors, or writes into
    ``out``: n_words int32[n_out] tensors with one element stride, e.g.
    the columns of a row-major int32[rows, n_words] table. On a CUDA
    tensor this launches the kernel on the current stream and adds one
    to the "launches: pack_words" counter (none for 0 rows); on a CPU
    tensor it runs ``pack_words_reference``. Either adds ``k1_bytes``
    to "k1_bytes"."""
    n_out = text.shape[0] if n_out is None else int(n_out)
    _check_args(text, table, bits, spw, n_real, offset, n_words, n_out)
    if text.device.type == "cpu":
        out = pack_words_reference(text, table, bits, spw, n_real, n_words,
                                   offset, n_out, out)
    else:
        out = _launch(text, table, bits, spw, n_real, n_words, offset,
                      n_out, out)
        count("launches: pack_words", int(n_out > 0))
    count("k1_bytes", k1_bytes(n_real, offset, n_out, n_words, spw))
    return out


def pack_ranks(text: torch.Tensor, remap: torch.Tensor, bits: int, h0: int,
               n_real: int, offset: int = 0) -> torch.Tensor:
    """Packed initial ranks int32[n] of uint8 ``text``: one word of
    ``h0`` codes per position (see module doc).

    On a CUDA tensor this launches the kernel on the current stream and
    adds one to the "launches: pack_ranks" counter; on a CPU tensor it
    returns ``pack_ranks_reference``. Either adds ``k1_bytes`` to
    "k1_bytes"."""
    _check_args(text, remap, bits, h0, n_real, offset)
    n = text.shape[0]
    if text.device.type == "cpu":
        out = pack_ranks_reference(text, remap, bits, h0, n_real, offset)
    else:
        out = _launch(text, remap, bits, h0, n_real, 1, offset, n, None)[0]
        count("launches: pack_ranks", int(n > 0))
    count("k1_bytes", k1_bytes(n_real, offset, n, 1, h0))
    return out
