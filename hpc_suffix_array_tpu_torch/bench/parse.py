"""STRUCTURED_RESULTS text-protocol parser (both dialects).

Counterpart of ``hpc_suffix_array_tpu/bench/parse.py`` (pure text; the
port keeps its own copy). The harness calls the library in-process, but
external consumers of the CLI scrape its stdout for the
``===STRUCTURED_RESULTS===`` and ``--- STRUCTURED_RESULTS ---`` blocks;
this module is the parser for that contract, the port's ``PATH``,
``RERUN``, ``STATUS`` and ``ERROR`` lines included (kept as strings
under lower-cased keys).
"""

from __future__ import annotations

import re

_SEQ_BLOCK = re.compile(
    r"===STRUCTURED_RESULTS===(.*?)===END_RESULTS===", re.S)
_MPI_BLOCK = re.compile(
    r"--- STRUCTURED_RESULTS ---(.*?)--- END_STRUCTURED_RESULTS ---", re.S)

_FLOAT_KEYS = {"TOTAL_TIME", "SA_TIME", "LCP_TIME"}
_INT_KEYS = {"FILE_SIZE", "PROCESSES", "ACTUAL_STRING_LENGTH",
             "MPI_PROCESSES"}


def parse_structured_results(stdout: str) -> dict:
    """Parse the first STRUCTURED_RESULTS block found (either dialect).

    Returns {} when no block is present. Keys are lower-cased; numeric
    fields are converted. The dialect is reported under ``dialect``.
    """
    m = _SEQ_BLOCK.search(stdout)
    dialect = "sequential"
    if not m:
        m = _MPI_BLOCK.search(stdout)
        dialect = "mpi"
    if not m:
        return {}
    out = {"dialect": dialect}
    for line in m.group(1).strip().splitlines():
        if ":" not in line:
            continue
        key, _, value = line.partition(":")
        key = key.strip()
        value = value.strip()
        if key in _FLOAT_KEYS:
            out[key.lower()] = float(value)
        elif key in _INT_KEYS:
            out[key.lower()] = int(value)
        else:
            out[key.lower()] = value
    return out


def parse_all_structured_results(stdout: str) -> list[dict]:
    """All blocks found, both dialects (a ``--dialect both`` run emits one
    of each)."""
    results = []
    for pat in (_SEQ_BLOCK, _MPI_BLOCK):
        for m in pat.finditer(stdout):
            results.append(parse_structured_results(m.group(0)))
    return results
