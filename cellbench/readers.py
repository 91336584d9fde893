"""Helpers the metric readers share (``e2e/*.py``, ``layers/*.py``)."""

from __future__ import annotations

import re

# The port's CUDA kernels are functions in an anonymous namespace, some
# of them templates ("void (anonymous namespace)::pack_words_kernel<2,
# 0>(...)", "(anonymous namespace)::onesweep_pass_kernel(...)");
# PyTorch's and CUB's live in named ones ("void at::native::...").
_PORT_KERNEL = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+)[<(]")


def port_kernel(name: str, *functions: str) -> bool:
    """Whether ``name`` is a kernel of the port's library, and one of
    ``functions`` when they are given."""
    m = _PORT_KERNEL.match(name)
    return m is not None and (not functions or m.group(1) in functions)


def kernel_ms(run, pick) -> float | None:
    """Device ms per traced build of the kernels whose names ``pick``
    accepts; None without a trace or when none of them ran."""
    if run.trace is None or not run.trace["n_builds"]:
        return None
    hits = [v[0] for k, v in run.trace["kernels"].items() if pick(k)]
    if not hits:
        return None
    return sum(hits) / 1e3 / run.trace["n_builds"]


def span_ms(run, field: str) -> float | None:
    """Mean of a build span (seconds) in ms over the unprofiled builds."""
    builds = run.plain
    if not builds:
        return None
    return 1e3 * sum(getattr(b, field) for b in builds) / len(builds)


def info_mean(run, get) -> float | None:
    """Mean per build of ``get(info)`` over the unprofiled builds, 0 for
    a build where it is None; None when no build reports it."""
    values = [get(b.info) for b in run.plain]
    if all(v is None for v in values):
        return None
    return sum(v or 0.0 for v in values) / len(values)
