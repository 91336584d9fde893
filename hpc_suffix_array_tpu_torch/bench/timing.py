"""Per-phase benchmark timing: SA build / LCP build / LRS search.

Counterpart of ``hpc_suffix_array_tpu/bench/timing.py``: the same
``BenchmarkResult`` record, field for field, and the same phase
protocol with the 3*n*sizeof(int32) working-set estimate.

  * every phase is fenced at both ends (``utils.profiling.phase_timer``
    waits for the device), so work queued by one phase cannot run inside
    the next one's window;
  * an untimed warm-up run precedes the timed run, and the difference is
    reported as ``compile_time``. The name is the CSV schema's. Nothing
    here compiles at run time as a JIT does: on a card the warm-up pays
    the first-use costs (the build or load of the kernel library, the
    first allocations), so ``compile_time`` is those.

Phases are timed through ``utils.profiling.phase_timer``, so the CSV rows
and a traced CLI run share one timing mechanism.
"""

from __future__ import annotations

import contextlib
from dataclasses import asdict, dataclass

from hpc_suffix_array_tpu_torch.cli import implementation_name
from hpc_suffix_array_tpu_torch.device import resolve_device, synchronize
from hpc_suffix_array_tpu_torch.utils.profiling import (
    PhaseTimings, phase_timer)


@dataclass
class BenchmarkResult:
    """One timed pipeline run (times in seconds)."""

    implementation: str
    input_type: str
    string_length: int
    total_time: float
    sa_time: float
    lcp_time: float
    lrs_time: float
    memory_used: int
    lrs_length: int = 0
    valid: bool | None = None
    compile_time: float = 0.0
    # Which builder served the SA phase (direct/msd/doubling/...):
    # speedup pairs whose baseline ran a different builder measure the
    # routing, not scaling, and are flagged downstream
    # (harness.add_speedup_efficiency).
    builder: str = ""

    def as_row(self) -> dict:
        return asdict(self)


def _pipeline(arr, dev, timings: PhaseTimings | None, text_dev=None,
              info: dict | None = None):
    """One SA + LCP + LRS pipeline as ``cli.run`` runs it; phases timed
    into ``timings`` if given.

    ``text_dev``: optional uint8 copy of ``arr`` already on ``dev`` (twin
    corpora); without it the text is staged inside the SA phase, as in
    the CLI. Above ``lcp_big_min()`` one fused carried-keys build gives
    SA and LCP together and lands in the SA phase; the LCP phase is then
    empty. Timing the two builders back to back there would charge the
    full-text sort twice, a cost no CLI user pays."""
    from hpc_suffix_array_tpu_torch.core.lcp import (
        build_lcp_array, build_sa_lcp, lcp_big_min)
    from hpc_suffix_array_tpu_torch.core.lrs import (
        find_longest_repeated_substring)
    from hpc_suffix_array_tpu_torch.core.suffix_array import (
        as_byte_tensor, build_suffix_array)

    def phase(name):
        if timings is None:
            return contextlib.nullcontext()
        return phase_timer(timings, name, dev)

    fused = int(arr.shape[0]) > lcp_big_min()
    lcp = None
    with phase("sa_build"):
        if text_dev is None:
            text_dev = as_byte_tensor(arr, dev)
        if fused:
            sa, lcp = build_sa_lcp(arr, device=dev, info=info,
                                   text_dev=text_dev)
        else:
            sa = build_suffix_array(arr, device=dev, info=info,
                                    text_dev=text_dev)
    with phase("lcp_build"):
        if not fused:
            lcp = build_lcp_array(arr, sa, device=dev, info=info,
                                  text_dev=text_dev)
    with phase("lrs_search"):
        lrs = find_longest_repeated_substring(text_dev, sa, lcp, device=dev)
    return sa, lcp, lrs, text_dev


def run_benchmark(text, implementation: str | None = None,
                  input_type: str = "random", device="cuda",
                  validate: bool = False, warmup: bool = True,
                  text_dev=None) -> BenchmarkResult:
    """Time one full SA + LCP + LRS pipeline on ``text`` on ``device``.

    ``implementation`` defaults to the CLI's name for the device (``cuda``
    / ``torch_cpu``). ``warmup=True`` runs the pipeline once untimed
    first, ending in a device fence; the warm-up's time minus the timed
    run's is reported as ``compile_time`` (see the module docstring).
    ``text_dev``: pre-staged device copy (see ``_pipeline``)."""
    import time

    from hpc_suffix_array_tpu_torch.core.suffix_array import as_byte_array

    dev = resolve_device(device)
    arr = as_byte_array(text)
    n = int(arr.shape[0])

    if warmup:
        synchronize(dev)
        t0 = time.perf_counter()
        _pipeline(arr, dev, None, text_dev)
        synchronize(dev)
        warmup_total = time.perf_counter() - t0

    info: dict = {}
    timings = PhaseTimings()
    with phase_timer(timings, "total", dev):
        sa, lcp, lrs, staged = _pipeline(arr, dev, timings, text_dev, info)

    valid = None
    if validate:
        from hpc_suffix_array_tpu_torch.core.validate import (
            is_valid_suffix_array)
        valid = bool(is_valid_suffix_array(staged, sa, device=dev))

    return BenchmarkResult(
        implementation=implementation or implementation_name(dev),
        input_type=input_type,
        string_length=n,
        total_time=timings["total"],
        sa_time=timings["sa_build"],
        lcp_time=timings["lcp_build"],
        lrs_time=timings["lrs_search"],
        memory_used=3 * n * 4,
        lrs_length=len(lrs) if lrs else 0,
        valid=valid,
        compile_time=(max(0.0, warmup_total - timings["total"])
                      if warmup else 0.0),
        builder=info.get("path", ""),
    )
