"""95th percentile over every request due in the window of (finish - first
token) / (output tokens - 1); a failed request sorts last."""

from perfbench.readers import tpot_s
from perfbench.stats import percentile

LAYER = "end to end"
UNIT = "ms"
MOVES = None


def read(run):
    sample = run.sample
    return 1e3 * percentile([tpot_s(run, r) for r in sample], 95) if sample else None
