"""Engine loop: wall time of the window's engine steps that only decoded
over the model steps they ran (host clock around ``Engine.step``; the
profiled slice left out)."""

LAYER = "engine loop"
UNIT = "ms"
MOVES = "tpot_p95_ms"


def read(run):
    steps = [s for s in run.window_steps if s.decode_only]
    n = sum(s.decode_steps for s in steps)
    return 1e3 * sum(s.wall for s in steps) / n if n else None
