"""The harness's fenced span around the ``build_sa_lcp`` call (the SA and LCP
router and builders), mean ms per build."""

from cellbench.readers import span_ms


def read(run):
    return span_ms(run, "sa_lcp_s")
