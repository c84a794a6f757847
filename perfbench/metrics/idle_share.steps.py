"""Device: the share of the profiled slice in which the engine had work
and no kernel or copy ran on the card, in percent. Gaps in which the
engine had no ready work (the pod waiting for arrivals) and the card ran
nothing are left out. Busy time above the time with work means the
records do not lie where the steps do: nothing is read then."""

from perfbench.readers import busy_and_working_s

LAYER = "device"
UNIT = "%"
MOVES = "tpot_p95_ms"


def read(run):
    busy, working = busy_and_working_s(run)
    if working <= 0 or not run.slice.records:
        return None
    share = 1.0 - busy / working
    return 100.0 * share if share >= 0.0 else None
