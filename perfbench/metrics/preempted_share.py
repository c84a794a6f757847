"""Scheduler and block manager: the share of the window's requests (those
due before the profiled slice) that the engine preempted at least once
(``num_preemptions``, counted by the program), in percent."""

LAYER = "scheduler and block manager"
UNIT = "%"
MOVES = "ttft_p95_ms"


def read(run):
    seqs = [r.seq for r in run.layer_sample if r.seq is not None]
    if not seqs or not all(hasattr(s, "num_preemptions") for s in seqs):
        return None
    return 100.0 * sum(s.num_preemptions >= 1 for s in seqs) / len(seqs)
