"""Stable LSD radix sort: the hand-written kernels and their plain versions.

``radix_sort_words`` sorts an int32 payload by 1-3 int32 key words, or
1-4 key words with no payload, on the onesweep kernels of
``csrc/onesweep.cu``:

- ``digit_histograms`` reads the key words once and counts the digits
  of every pass;
- the plan (``plan_passes``) scans each row into the pass's global digit
  starts and skips every pass whose digit is the same for all elements
  (a stable partition by a constant digit is the identity);
- ``onesweep_pass`` runs each remaining pass in one launch: every tile
  stages its columns in shared memory, publishes its digit counts,
  ranks its elements by digit, finds its global offsets by decoupled
  look-back over earlier tiles, and writes every column once to its
  final place. The tile's size follows the column count
  (``tile_elems``).

The onesweep pass computes what ``experiments/radix_write.py::
radix_pass_dma`` computes: Pallas ``block_digit_sort`` and
``place_runs`` with XLA scans between them. Their first port, K2
``block_digit_sort`` + ``run_offsets`` + K3 ``place_runs``
(``csrc/radix.cu``, ``radix_pass``), stays beside it: K2 stable-sorts
every block of ``BLOCK`` elements by the digit and emits the per-block
histogram, ``run_offsets`` scans it into each (block, digit) run's
global and block-local start, and K3 copies each run to its global
place. The sort no longer runs them.

A pass carries up to four int32 columns; digits are read from the key as
uint32, so keys order as unsigned integers. ``rbits`` 4 is the TPU
version's digit (the parity test); the builder uses ``RBITS = 8``.

Each wrapper launches its kernel for CUDA tensors and adds one to its
"launches: <name>" counter in the recorder of ``utils/profiling.py``;
for CPU tensors it runs its ``*_reference``. There is no fallback
between the two: a CUDA call launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from hpc_suffix_array_tpu_torch.kernels import _build
from hpc_suffix_array_tpu_torch.utils.profiling import count, device_counter

BLOCK = 4096          # elements per K2/K3 block (csrc/radix.cu kBlock)
TILE = 4096           # the smallest onesweep tile: LookBack's sizing
# Elements per onesweep tile in a pass on 1-4 columns (csrc/onesweep.cu
# kShapeThreads x kShapeItems).
TILES = (6144, 8192, 10240, 8192)
MAX_COLS = 4          # columns one pass carries (3 key words + payload)
MAX_RADIX = 256       # look-back status words per tile (rbits <= 8)
RBITS = 8             # digit width of the builder's sort


def _check(cols, key_col: int, shift: int, rbits: int) -> None:
    if not 1 <= len(cols) <= MAX_COLS:
        raise ValueError(f"need 1..{MAX_COLS} columns, got {len(cols)}")
    if not 0 <= key_col < len(cols):
        raise ValueError(f"key_col={key_col} outside [0, {len(cols)})")
    n, dev = cols[0].shape[0], cols[0].device
    for c in cols:
        if c.dtype != torch.int32 or c.dim() != 1 or c.shape[0] != n:
            raise TypeError(f"columns must be int32[{n}], got {c.dtype} "
                            f"{tuple(c.shape)}")
        if c.device != dev or not c.is_contiguous():
            raise ValueError("columns must be contiguous and on one device")
    if n >= 1 << 31:
        raise ValueError(f"n={n} needs int64 offsets; at most 2^31-1")
    if not 1 <= rbits <= 8 or not 0 <= shift < 32:
        raise ValueError(f"need 1 <= rbits <= 8 and 0 <= shift < 32; got "
                         f"rbits={rbits}, shift={shift}")


def _device_kind(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


def _digits(key: torch.Tensor, shift: int, rbits: int) -> torch.Tensor:
    """int64 digit of each key read as uint32."""
    return ((key.long() & 0xFFFFFFFF) >> shift) & ((1 << rbits) - 1)


def n_blocks(n: int) -> int:
    return -(-n // BLOCK)


def block_digit_sort_reference(cols, key_col: int, shift: int, rbits: int):
    """Plain K2: per-block stable ``argsort`` of the digit plus
    ``bincount``. Returns (block-sorted columns, hist int32[nb, 2^rbits])."""
    _check(cols, key_col, shift, rbits)
    n, dev = cols[0].shape[0], cols[0].device
    radix, nb = 1 << rbits, n_blocks(n)
    dig = _digits(cols[key_col], shift, rbits)
    padded = torch.full((nb * BLOCK,), radix, dtype=torch.int64, device=dev)
    padded[:n] = dig
    order = torch.sort(padded.view(nb, BLOCK), dim=1, stable=True).indices
    order += torch.arange(nb, device=dev)[:, None] * BLOCK
    order = order.view(-1)[:n]      # the pads sort last in the last block
    block = torch.arange(n, device=dev) // BLOCK
    hist = torch.bincount(block * radix + dig, minlength=nb * radix)
    return ([c[order] for c in cols],
            hist.view(nb, radix).to(torch.int32))


def run_offsets(hist: torch.Tensor):
    """(run_dst, run_src) int32[nb, R] from K2's histogram: the global
    start of each (block, digit) run in digit-major order, and its start
    inside the block (``radix_pass_dma``'s scans, radix_write.py:371-379).

    The global starts are one exclusive scan of the histogram read
    digit-major: a cumsum along dim 0 of the [nb, R] table runs as R
    serial column scans on the card (on an H100, 24.0 ms against 0.57 ms
    per pass for the [65536, 256] table of a 2^28 sort)."""
    radix = hist.shape[1]
    flat = hist.t().contiguous().view(-1)           # digit-major (d, b)
    run_dst = torch.cumsum(flat, 0, dtype=torch.int32) - flat
    run_dst = run_dst.view(radix, -1).t().contiguous()
    run_src = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    return run_dst, run_src


def place_runs_reference(staged, key_col: int, shift: int, rbits: int,
                         run_dst: torch.Tensor, run_src: torch.Tensor,
                         out=None):
    """Plain K3: an index copy of each staged element to
    ``run_dst[b, d] + j - run_src[b, d]``."""
    _check(staged, key_col, shift, rbits)
    n, dev = staged[0].shape[0], staged[0].device
    j = torch.arange(n, device=dev)
    flat = (j // BLOCK) * (1 << rbits) + _digits(staged[key_col], shift,
                                                 rbits)
    to = (run_dst.view(-1)[flat].long() - run_src.view(-1)[flat].long()
          + j % BLOCK)
    out = [torch.empty_like(c) for c in staged] if out is None else out
    for o, c in zip(out, staged):
        o[to] = c
    return out


def _ptrs(cols):
    return [c.data_ptr() for c in cols] + [None] * (MAX_COLS - len(cols))


def _launch_cols(cols, out):
    lib = _build.load()
    if lib.sa_radix_block_elems() != BLOCK:
        raise RuntimeError("csrc/radix.cu kBlock differs from radix.BLOCK")
    return lib, _ptrs(cols) + _ptrs(out)


def block_digit_sort(cols, key_col: int, shift: int, rbits: int, out=None):
    """K2 (see module doc). ``out``: optional staging columns to write."""
    _check(cols, key_col, shift, rbits)
    if _device_kind(cols[0], "block_digit_sort") == "cpu":
        staged, hist = block_digit_sort_reference(cols, key_col, shift,
                                                  rbits)
        if out is None:
            return staged, hist
        for o, s in zip(out, staged):
            o.copy_(s)
        return out, hist
    n, dev = cols[0].shape[0], cols[0].device
    out = [torch.empty_like(c) for c in cols] if out is None else out
    hist = torch.empty((n_blocks(n), 1 << rbits), dtype=torch.int32,
                       device=dev)
    if n == 0:
        return out, hist
    lib, ptrs = _launch_cols(cols, out)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_block_digit_sort(*ptrs, len(cols), key_col, n, shift,
                                      rbits, hist.data_ptr(), stream)
    _build.check(err, "sa_block_digit_sort")
    count("launches: block_digit_sort")
    return out, hist


def place_runs(staged, key_col: int, shift: int, rbits: int,
               run_dst: torch.Tensor, run_src: torch.Tensor, out=None):
    """K3 (see module doc). ``out``: optional columns to write into."""
    _check(staged, key_col, shift, rbits)
    if _device_kind(staged[0], "place_runs") == "cpu":
        return place_runs_reference(staged, key_col, shift, rbits, run_dst,
                                    run_src, out)
    n = staged[0].shape[0]
    shape = (n_blocks(n), 1 << rbits)
    for t in (run_dst, run_src):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != staged[0].device or not t.is_contiguous()):
            raise TypeError(f"run offsets must be contiguous int32{shape} "
                            f"on {staged[0].device}")
    out = [torch.empty_like(c) for c in staged] if out is None else out
    if n == 0:
        return out
    lib, ptrs = _launch_cols(staged, out)
    with torch.cuda.device(staged[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_place_runs(*ptrs, len(staged), key_col, n, shift, rbits,
                                run_dst.data_ptr(), run_src.data_ptr(),
                                stream)
    _build.check(err, "sa_place_runs")
    count("launches: place_runs")
    return out


def radix_pass(cols, key_col: int, shift: int, rbits: int, staging=None):
    """One stable pass, in place: ``cols`` come back partitioned by the
    digit (K2 into ``staging``, K3 back into ``cols``)."""
    staged, hist = block_digit_sort(cols, key_col, shift, rbits, staging)
    run_dst, run_src = run_offsets(hist)
    return place_runs(staged, key_col, shift, rbits, run_dst, run_src,
                      out=cols)


def _check_words(words, payload, live_bits, max_words: int = MAX_COLS - 1
                 ) -> list[int]:
    """Checks the sort's columns (``payload`` may be None); returns the
    live bits of each word (``live_bits``: one int for every word, or
    one entry each)."""
    if not 1 <= len(words) <= max_words:
        raise ValueError(f"need 1..{max_words} key words, got {len(words)}")
    per_word = ([live_bits] * len(words) if isinstance(live_bits, int)
                else list(live_bits))
    if len(per_word) != len(words):
        raise ValueError(f"{len(per_word)} live_bits entries for "
                         f"{len(words)} words")
    for b in per_word:
        if not 1 <= b <= 32:
            raise ValueError(f"live_bits={b} outside [1, 32]")
    _check(list(words) + ([] if payload is None else [payload]), 0, 0, 1)
    return per_word


def _check_rbits(rbits: int) -> None:
    if not 1 <= rbits <= 8:
        raise ValueError(f"need 1 <= rbits <= 8, got {rbits}")


def tile_elems(n_cols: int) -> int:
    """Elements a onesweep tile holds in a pass on ``n_cols`` columns."""
    if not 1 <= n_cols <= MAX_COLS:
        raise ValueError(f"need 1..{MAX_COLS} columns, got {n_cols}")
    return TILES[n_cols - 1]


def n_tiles(n: int, tile: int = TILE) -> int:
    return -(-n // tile)


def pass_plan(per_word: list[int], rbits: int) -> list[tuple[int, int, int]]:
    """(word, shift, bits) of each pass, in the order the sort runs
    them: the least significant word first, each word's low digit first;
    a word's last digit takes only its remaining live bits."""
    return [(w, shift, min(rbits, per_word[w] - shift))
            for w in reversed(range(len(per_word)))
            for shift in range(0, per_word[w], rbits)]


def _histograms_reference(words, plan, rbits: int) -> torch.Tensor:
    radix = 1 << rbits
    hist = torch.zeros((len(plan), radix), dtype=torch.int32,
                       device=words[0].device)
    for p, (w, shift, bits) in enumerate(plan):
        hist[p] = torch.bincount(_digits(words[w], shift, bits),
                                 minlength=radix)
    return hist


def digit_histograms_reference(words, live_bits, rbits: int = RBITS):
    """Plain ``digit_histograms``: one ``bincount`` per pass."""
    per_word = _check_words(words, None, live_bits)
    _check_rbits(rbits)
    return _histograms_reference(words, pass_plan(per_word, rbits), rbits)


def _histograms(words, plan, rbits: int) -> torch.Tensor:
    """The digit_histograms kernel over ``plan`` (CUDA words)."""
    n, dev = words[0].shape[0], words[0].device
    hist = torch.zeros((len(plan), 1 << rbits), dtype=torch.int32,
                       device=dev)
    if n == 0:
        return hist
    lib = _build.load()

    def field(i):
        return (ctypes.c_int * len(plan))(*(step[i] for step in plan))

    ptrs = [w.data_ptr() for w in words] + [None] * (MAX_COLS - 1
                                                     - len(words))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_digit_histograms(*ptrs, len(words), n, len(plan),
                                      field(0), field(1), field(2), rbits,
                                      hist.data_ptr(), stream)
    _build.check(err, "sa_digit_histograms")
    count("launches: digit_histograms")
    return hist


def digit_histograms(words, live_bits, rbits: int = RBITS):
    """Global digit counts of every pass that ``radix_sort_words(words,
    ..., live_bits, rbits)`` runs: int32[P, 2^rbits], one row per pass in
    ``pass_plan`` order, each counting the pass's own digit (``min(rbits,
    live - shift)`` bits). On CUDA one kernel reads each word once."""
    per_word = _check_words(words, None, live_bits)
    _check_rbits(rbits)
    plan = pass_plan(per_word, rbits)
    if _device_kind(words[0], "digit_histograms") == "cpu":
        return _histograms_reference(words, plan, rbits)
    return _histograms(words, plan, rbits)


def plan_passes(hist: torch.Tensor):
    """(starts, run) from the passes' histograms ``hist`` int32[P, R]:
    ``starts`` int32[P, R] is each row's exclusive scan, every digit's
    first global place; ``run[p]`` is False where all elements share one
    digit in pass p, which makes that pass the identity, so it is
    skipped. One device-to-host read of P flags."""
    starts = torch.cumsum(hist, 1, dtype=torch.int32) - hist
    run = ((hist != 0).sum(1) > 1).tolist()
    return starts, run


def onesweep_pass_reference(cols, key_col: int, shift: int, rbits: int,
                            out=None, digit_starts=None):
    """Plain onesweep pass: a stable argsort of the digit (read as
    uint32) and a gather of every column, into ``out`` when given.

    With ``digit_starts`` the element of rank r among those of digit d
    goes to ``out[digit_starts[d] + r]``, and ``out`` may be longer than
    the input (``onesweep_pass``'s relaxed contract; checked here against
    the pass's own digit counts)."""
    _check(cols, key_col, shift, rbits)
    digit = _digits(cols[key_col], shift, rbits)
    order = torch.sort(digit, stable=True).indices
    moved = [c[order] for c in cols]
    if digit_starts is None:
        if out is None:
            return moved
        for o, m in zip(out, moved):
            o.copy_(m)
        return out
    n = cols[0].shape[0]
    out = [torch.empty_like(c) for c in cols] if out is None else out
    hist = torch.bincount(digit, minlength=1 << rbits)
    _check_pass_buffers(cols, out, digit_starts, rbits, hist.tolist())
    first = torch.cumsum(hist, 0) - hist
    sd = digit[order]
    to = (digit_starts.long()[sd] - first[sd]
          + torch.arange(n, device=digit.device))
    for o, m in zip(out, moved):
        o[to] = m
    return out


class LookBack:
    """Scratch of the onesweep passes of one sort: a zeroed 64-bit
    status word per (tile, digit) and a zeroed tile counter per pass.
    Each pass tags its status words with its own epoch (1, 2, ...), so
    one zeroing, at the first pass, serves every pass of the sort. The
    status is sized by the smallest tile (``TILE``), so it fits a pass
    on any number of columns."""

    def __init__(self, n: int, passes: int, device):
        self.n, self.passes, self.device = n, passes, device
        self.epoch = 0
        self.status = self.counters = None

    def next_pass(self):
        """(status, tile counter, epoch) of the next pass."""
        if self.epoch == self.passes:
            raise RuntimeError(f"LookBack holds {self.passes} passes")
        if self.status is None:
            self.status = torch.zeros(n_tiles(self.n) * MAX_RADIX,
                                      dtype=torch.int64, device=self.device)
            self.counters = torch.zeros(self.passes, dtype=torch.int32,
                                        device=self.device)
        self.epoch += 1
        return self.status, self.counters[self.epoch - 1], self.epoch


def _check_pass_buffers(cols, out, digit_starts, rbits: int,
                        digit_counts=None) -> None:
    """Output columns are int32, at least n long, on the inputs' device
    and not the inputs. Outputs longer than n (a pass writing into a part
    of larger columns) need ``digit_counts``, the pass's count of each
    digit on the host: every digit's run ``[digit_starts[d], digit_starts
    [d] + digit_counts[d])`` must lie inside the outputs (one read of
    ``digit_starts`` to the host)."""
    n, dev = cols[0].shape[0], cols[0].device
    if len(out) != len(cols):
        raise ValueError(f"{len(out)} output columns for {len(cols)}")
    for o in out:
        if (o.dtype != torch.int32 or o.dim() != 1 or o.shape[0] < n
                or o.device != dev or not o.is_contiguous()):
            raise TypeError(f"output columns must be contiguous int32[>= "
                            f"{n}] on {dev}")
        if any(o.data_ptr() == c.data_ptr() for c in cols):
            raise ValueError("output columns must not be input columns")
    if (digit_starts.dtype != torch.int32 or digit_starts.dim() != 1
            or digit_starts.shape[0] < 1 << rbits
            or digit_starts.device != dev
            or not digit_starts.is_contiguous()):
        raise TypeError(f"digit_starts must be contiguous int32[>= "
                        f"{1 << rbits}] on {dev}")
    size = min(o.shape[0] for o in out)
    if size == n and digit_counts is None:
        return
    if digit_counts is None:
        raise ValueError(f"outputs of {size} elements for an input of {n} "
                         "need digit_counts")
    counts = [int(c) for c in digit_counts][:1 << rbits]
    starts = digit_starts[:len(counts)].tolist()
    if sum(counts) != n:
        raise ValueError(f"digit_counts sum to {sum(counts)}, not n={n}")
    for d, (s, c) in enumerate(zip(starts, counts)):
        if c and not 0 <= s <= size - c:
            raise ValueError(f"digit {d}: run [{s}, {s + c}) outside the "
                             f"outputs of {size} elements")


def onesweep_pass(cols, key_col: int, shift: int, rbits: int, digit_starts,
                  lookback: LookBack, out=None, digit_counts=None):
    """One stable LSD pass of ``cols`` by the ``rbits``-bit digit of
    ``cols[key_col]`` at ``shift``, written to ``out`` (new columns when
    None; never the inputs). ``digit_starts`` int32[>= 2^rbits] holds
    every digit's first global place (a row of ``plan_passes``' starts);
    ``lookback`` is the sort's ``LookBack``. ``out`` may be longer than
    the input when ``digit_counts`` (host) bounds every digit's run
    inside it (see ``_check_pass_buffers``): the MSD scatter writes a
    chunk's buckets into full-length slabs this way. On CPU tensors the
    plain version places by ``digit_starts`` and needs no look-back.
    In a traced build (``utils/profiling.device_counter``) the kernel
    adds the status words its look-backs examined to the counter
    "onesweep_lookback_reads", and the wrapper its tiles to
    "onesweep_tiles"."""
    _check(cols, key_col, shift, rbits)
    if _device_kind(cols[0], "onesweep_pass") == "cpu":
        return onesweep_pass_reference(cols, key_col, shift, rbits, out,
                                       digit_starts)
    n, dev = cols[0].shape[0], cols[0].device
    out = [torch.empty_like(c) for c in cols] if out is None else out
    _check_pass_buffers(cols, out, digit_starts, rbits, digit_counts)
    if n == 0:
        return out
    if lookback.n < n:
        raise ValueError(f"LookBack for n={lookback.n} used at n={n}")
    status, counter, epoch = lookback.next_pass()
    lib = _build.load()
    tile = tile_elems(len(cols))
    if lib.sa_onesweep_tile_elems(len(cols)) != tile:
        raise RuntimeError("csrc/onesweep.cu's tile differs from "
                           "radix.TILES")
    # Traced builds only: the status words the look-backs examined, read
    # once at the record's close.
    reads = device_counter("onesweep_lookback_reads", dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sa_onesweep_pass(*_ptrs(cols), *_ptrs(out), len(cols),
                                   key_col, n, shift, rbits,
                                   digit_starts.data_ptr(),
                                   status.data_ptr(), counter.data_ptr(),
                                   epoch, None if reads is None
                                   else reads.data_ptr(), stream)
    _build.check(err, "sa_onesweep_pass")
    count("launches: onesweep_pass")
    if reads is not None:
        count("onesweep_tiles", n_tiles(n, tile))
    return out


def sort_passes(cols, per_word: list[int], rbits: int, histograms,
                one_pass) -> tuple[int, int]:
    """The pass loop of ``radix_sort_words``, in place on ``cols`` (the
    key words, most significant first, then the payload): the
    histograms of every pass (``histograms(words, per_word, rbits)``),
    the plan, then ``one_pass(src, key_col, shift, bits, digit_starts,
    dst)`` for each pass that is not skipped, ping-ponging between
    ``cols`` and one staging set, and one copy back when the number of
    executed passes is odd. ``cols`` may hold the key words alone (a
    keys-only sort). Returns (executed, skipped)."""
    plan = pass_plan(per_word, rbits)
    starts, run = plan_passes(histograms(cols[:len(per_word)], per_word,
                                         rbits))
    todo = [p for p in range(len(plan)) if run[p]]
    if todo:
        src, dst = cols, [torch.empty_like(c) for c in cols]
        for p in todo:
            w, shift, bits = plan[p]
            one_pass(src, w, shift, bits, starts[p], dst)
            src, dst = dst, src
        if src is not cols:
            for c, s in zip(cols, src):
                c.copy_(s)
    return len(todo), len(plan) - len(todo)


def _sort_columns(words, payload) -> list:
    return list(words) + ([] if payload is None else [payload])


def _max_words(payload) -> int:
    """Key words one sort takes: a pass carries MAX_COLS columns, so 3
    beside a payload and 4 in a keys-only sort."""
    return MAX_COLS - (payload is not None)


def sort_bytes(rows: int, columns: int) -> int:
    """Bytes a sort of ``rows`` rows of ``columns`` int32 columns must
    move, whatever its passes: every column read once and written once."""
    return 2 * rows * columns * 4


def radix_sort_words_reference(words, payload, live_bits):
    """Plain sort: stable ``torch.sort`` per word, least significant
    first, on the live bits. In place, like ``radix_sort_words``."""
    per_word = _check_words(words, payload, live_bits, _max_words(payload))
    perm = torch.arange(words[0].shape[0], device=words[0].device)
    for w, b in reversed(list(zip(words, per_word))):
        key = (w.long() & ((1 << b) - 1))[perm]
        perm = perm[torch.sort(key, stable=True).indices]
    for c in _sort_columns(words, payload):
        c.copy_(c[perm])
    return list(words), payload


def _split_histograms(words, per_word, rbits: int) -> torch.Tensor:
    """``digit_histograms`` of up to four words in launches of at most
    three (``csrc/onesweep.cu`` kMaxWords): the words after the first,
    then the first, which is the plan's row order."""
    if len(words) <= MAX_COLS - 1:
        return digit_histograms(words, per_word, rbits)
    return torch.cat([digit_histograms(words[1:], per_word[1:], rbits),
                      digit_histograms(words[:1], per_word[:1], rbits)])


def radix_sort_words(words, payload, live_bits, rbits: int = RBITS):
    """Stable sort of ``payload`` (int32[n]) by the key words (1-3
    int32[n], most significant first), on the low live bits of each
    word, read as unsigned. ``live_bits`` is one int for every word or a
    list with one entry per word (a refinement round's segment word
    needs only ceil(log2(rows)) bits). ``payload`` None sorts 1-4 key
    words alone (keys-only: where the last key is unique, it is the
    index, and no payload column is moved).

    Sorts IN PLACE: the inputs are one of the two buffer sets the passes
    ping-pong between, so the sort needs one staging set on top.
    Returns (words, payload), sorted. On CUDA tensors it runs one
    digit_histograms launch (two for four words) and one onesweep_pass
    launch per pass whose digit is not constant, of ceil(live_bits /
    rbits) per word, and adds to the "passes_run" and "passes_skipped"
    counters; on CPU tensors it runs ``radix_sort_words_reference``.
    Either adds ``sort_bytes`` to "sort_bytes"."""
    per_word = _check_words(words, payload, live_bits, _max_words(payload))
    _check_rbits(rbits)
    cols = _sort_columns(words, payload)
    moved = sort_bytes(words[0].shape[0], len(cols))
    if _device_kind(words[0], "radix_sort_words") == "cpu":
        out = radix_sort_words_reference(words, payload, per_word)
        count("sort_bytes", moved)
        return out
    lookback = LookBack(words[0].shape[0], len(pass_plan(per_word, rbits)),
                        words[0].device)

    def one_pass(src, key_col, shift, bits, digit_starts, dst):
        onesweep_pass(src, key_col, shift, bits, digit_starts, lookback, dst)

    run, skipped = sort_passes(cols, per_word, rbits, _split_histograms,
                               one_pass)
    count("passes_run", run)
    count("passes_skipped", skipped)
    count("sort_bytes", moved)
    return list(words), payload
