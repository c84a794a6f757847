"""Set-up: from process start to the first request of the window (kernel
load, weights, pod, warm-up and the traffic's ramp)."""

LAYER = "end to end"
UNIT = "s"
MOVES = None


def read(run):
    return run.setup_s
