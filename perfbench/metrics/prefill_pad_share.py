"""Engine loop: the share of the tokens the window's prefill dispatches
computed that were padding, in percent (the program's counters: a
dispatch computes rows × chunk tokens, of which ``prefill_valid_tokens``
are prompt tokens)."""

from perfbench.program import record, step_interval

LAYER = "engine loop"
UNIT = "%"
MOVES = "ttft_p50_ms"


def read(run):
    prog = record(run)
    if prog is None:
        return None
    computed = valid = 0
    for e in prog["steps"]:
        c = e["counters"]
        a, b = step_interval(e)
        if "prefill_rows" in c and run.w0 <= a and b <= run.w1:
            computed += c["prefill_rows"] * c["prefill_chunk"]
            valid += c["prefill_valid_tokens"]
    return 100.0 * (computed - valid) / computed if computed else None
