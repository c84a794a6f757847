"""Chat sessions: shared system prompts, multi-turn histories, think times.

Sizes come from the mix's ``shape_seed``: the start offsets (a Poisson
process at ``rate`` sessions/s, the same unit-rate gaps scaled by the
rate), and for each session its system prompt (Zipf over ``count``), its
turns (geometric, mean ``turns.mean``, at most ``turns.max``), each
turn's message and answer lengths (lognormal, clipped) and think time
(exponential). A session ends before the first turn whose prompt and
answer would pass ``max_context``. ``--seed`` draws every token id (and
the weights, elsewhere): every seed offers the same sizes and arrivals in
the same order. Ordering the sessions by the seed moved the work inside a
window by ±12 % between seeds, against 1–2 % between two runs of one seed.
"""

from __future__ import annotations

import numpy as np

from perfbench.load import Plan, Session, Turn


def _lognormal(rng, spec: dict) -> int:
    v = rng.lognormal(np.log(spec["median"]), spec["sigma"])
    return int(np.clip(round(v), spec["min"], spec["max"]))


def build(mix: dict, seed: int, rate: float, vocab: int) -> Plan:
    sp = mix["system_prompts"]
    arrivals = np.random.default_rng([mix["shape_seed"], 0])
    shapes = np.random.default_rng([mix["shape_seed"], 1])
    starts, t = [], 0.0
    while True:
        t += arrivals.exponential(1.0) / rate
        if t >= mix["horizon_s"]:
            break
        starts.append(t)
    zipf = 1.0 / np.arange(1, sp["count"] + 1) ** sp["zipf_s"]
    zipf /= zipf.sum()
    sizes = []
    for _ in starts:
        system = int(shapes.choice(sp["count"], p=zipf))
        n_turns = min(int(shapes.geometric(1.0 / mix["turns"]["mean"])), mix["turns"]["max"])
        turns, ctx = [], sp["tokens"]
        for _ in range(n_turns):
            msg = _lognormal(shapes, mix["message_tokens"])
            ans = _lognormal(shapes, mix["answer_tokens"])
            think = float(shapes.exponential(mix["think_s"]["mean"]))
            if ctx + msg + ans > mix["max_context"]:
                break
            turns.append((msg, ans, think))
            ctx += msg + ans if mix["carry_history"] else 0
        if turns:
            sizes.append((system, turns))

    ids = np.random.default_rng([seed, 2])
    prefixes = [ids.integers(0, vocab, sp["tokens"], dtype=np.int64) for _ in range(sp["count"])]
    sessions = []
    for start, (system, turns) in zip(starts, sizes):
        sessions.append(Session(
            start_s=start,
            prefix=system,
            turns=[Turn(ids.integers(0, vocab, msg, dtype=np.int64), ans, think)
                   for msg, ans, think in turns],
        ))
    return Plan(sessions=sessions, prefixes=prefixes, carry=mix["carry_history"])
