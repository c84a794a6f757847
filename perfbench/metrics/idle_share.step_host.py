"""Device: the share of the profiled slice's time with work in which the
card ran nothing while the host was in the step's schedule, host prefetch and publish, and its own time outside them, in percent. The records
are placed by the program's clock pair, and the time with work is taken as
``idle_share.steps`` takes it; the four ``idle_share.<group>`` sum to
the idle share on that placement (``perfbench/program.py``)."""

from perfbench.program import idle_share

LAYER = "device"
UNIT = "%"
MOVES = "tpot_p95_ms"


def read(run):
    return idle_share(run, "step_host")
