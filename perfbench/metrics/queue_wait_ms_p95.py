"""Pod server: 95th percentile over the window's requests (those due before
the profiled slice) of the wait
from arrival in the engine to the start of its prefill
(``prefill_start_time - arrival_time``, the pod's own stamps)."""

import math

from perfbench.stats import percentile

LAYER = "pod server"
UNIT = "ms"
MOVES = "ttft_p95_ms"


def read(run):
    waits = []
    for r in run.layer_sample:
        s = r.seq
        ok = not run.failed(r) and s.prefill_start_time is not None
        waits.append(1e3 * (s.prefill_start_time - s.arrival_time) if ok else math.inf)
    return percentile(waits, 95) if waits else None
