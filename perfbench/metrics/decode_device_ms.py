"""Decode dispatch: the card's own time of the decode bursts that the
window's decode-only steps launched, over the model steps they ran (the
program's ``device.decode`` spans; the profiled slice left out, as
``decode_step_ms`` leaves it out). Set beside ``decode_step_ms``, the
host's wall time of the same steps."""

from perfbench.program import window_entries

LAYER = "decode dispatch"
UNIT = "ms"
MOVES = "tpot_p95_ms"


def read(run):
    entries = window_entries(run)
    if entries is None:
        return None
    steps = secs = 0
    for e in entries:
        if e["kind"] != "decode":
            continue
        spans = [b - a for name, a, b in e["device"] if name == "device.decode"]
        if spans:
            steps += e["counters"]["decode_steps"]
            secs += sum(spans) / 1e9
    return 1e3 * secs / steps if steps else None
