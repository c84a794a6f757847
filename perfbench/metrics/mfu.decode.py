"""Model forward: model FLOPs of the window's decode-only steps over their
wall time and the card's bf16 peak, in percent. FLOPs from shapes: per
lane and model step, twice the active parameters (the head included),
and attention over the lane's context."""

from perfbench.work import PEAK_BF16_FLOPS, decode_flops

LAYER = "model forward"
UNIT = "%"
MOVES = "tpot_p95_ms"


def read(run):
    steps = [s for s in run.window_steps if s.decode_only]
    wall = sum(s.wall for s in steps)
    if not wall:
        return None
    flops = sum(decode_flops(run.m, c + j) for s in steps for j in range(s.decode_steps)
                for c in s.lanes)
    return 100.0 * flops / wall / PEAK_BF16_FLOPS
