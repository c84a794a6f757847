"""Device: the share of the profiled slice's time with work in which the
card ran nothing while the host was in the pod loop's own spans (``pod.admit``, ``pod.resolve``) or no engine step, in percent. The records
are placed by the program's clock pair, and the time with work is taken as
``idle_share.steps`` takes it; the four ``idle_share.<group>`` sum to
the idle share on that placement (``perfbench/program.py``)."""

from perfbench.program import idle_share

LAYER = "device"
UNIT = "%"
MOVES = "tpot_p95_ms"


def read(run):
    return idle_share(run, "loop")
