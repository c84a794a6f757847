"""Model forward: model FLOPs of the window's steps that prefilled over
their wall time and the card's bf16 peak, in percent. FLOPs from each
row's chunk and context (the head for the sampled row only)."""

from perfbench.work import PEAK_BF16_FLOPS, prefill_flops

LAYER = "model forward"
UNIT = "%"
MOVES = "ttft_p95_ms"


def read(run):
    steps = [s for s in run.window_steps if s.prefill]
    wall = sum(s.wall for s in steps)
    if not wall:
        return None
    flops = sum(prefill_flops(run.m, chunk, ctx) for s in steps for chunk, ctx in s.rows)
    return 100.0 * flops / wall / PEAK_BF16_FLOPS
