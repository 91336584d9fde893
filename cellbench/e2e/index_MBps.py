"""Text bytes indexed (SA + LCP + LRS) per second over the whole window,
from the first build's start to the last build's end, synchronised;
10**6 B/s."""


def read(run):
    if not run.done:
        return None
    window = run.builds[-1].end - run.builds[0].start
    return sum(b.n for b in run.done) / window / 1e6
