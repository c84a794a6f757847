"""Engine loop: the 95th percentile, over every output token after the
first of the window's requests (those due before the profiled slice), of
the time since its request's previous commit (0 for a token committed
with the one before it): the stall a streaming caller sees. Read from the
program's per-request commit stamps (``commit_times``)."""

from perfbench.program import commit_gaps_s
from perfbench.stats import percentile

LAYER = "engine loop"
UNIT = "ms"
MOVES = "tpot_p95_ms"


def read(run):
    gaps = []
    for r in run.layer_sample:
        if run.failed(r):
            continue
        g = commit_gaps_s(r.seq)
        if g is None:
            return None
        gaps += g
    return 1e3 * percentile(gaps, 95) if gaps else None
