"""95th percentile over every request due in the window of its
first-token time less the time it was due; a failed request sorts last."""

from perfbench.readers import ttft_s
from perfbench.stats import percentile

LAYER = "end to end"
UNIT = "ms"
MOVES = None


def read(run):
    sample = run.sample
    return 1e3 * percentile([ttft_s(run, r) for r in sample], 95) if sample else None
