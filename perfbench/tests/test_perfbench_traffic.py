"""The traffic generator: repeatable from a seed, the same sizes for every
seed, and within the mix's limits."""

import json
from collections import Counter

import numpy as np

from perfbench.spec import HERE, traffic_kind

MIX = json.loads((HERE / "traffic" / "chat_sessions.json").read_text())
sessions = traffic_kind("sessions")
VOCAB = 151_936


def _sizes(plan):
    return Counter((s.prefix is not None, len(s.turns), tuple((len(t.message), t.answer_len) for t in s.turns))
                   for s in plan.sessions)


def test_same_seed_same_plan():
    a, b = sessions.build(MIX, 2**33 + 5, 1.0, VOCAB), sessions.build(MIX, 2**33 + 5, 1.0, VOCAB)
    assert [s.start_s for s in a.sessions] == [s.start_s for s in b.sessions]
    for x, y in zip(a.sessions, b.sessions):
        assert x.prefix == y.prefix and len(x.turns) == len(y.turns)
        for tx, ty in zip(x.turns, y.turns):
            assert np.array_equal(tx.message, ty.message)
            assert (tx.answer_len, tx.think_s) == (ty.answer_len, ty.think_s)
    assert all(np.array_equal(p, q) for p, q in zip(a.prefixes, b.prefixes))


def test_other_seed_same_sizes_and_order_other_ids():
    a, b = sessions.build(MIX, 1, 1.0, VOCAB), sessions.build(MIX, 2, 1.0, VOCAB)
    assert [s.start_s for s in a.sessions] == [s.start_s for s in b.sessions]
    assert _sizes(a) == _sizes(b)
    assert a.turn_lengths() == b.turn_lengths()
    assert [s.prefix for s in a.sessions] == [s.prefix for s in b.sessions]
    assert not np.array_equal(a.prefixes[0], b.prefixes[0])
    assert not np.array_equal(a.sessions[0].turns[0].message, b.sessions[0].turns[0].message)


def test_rate_scales_start_times():
    a, b = sessions.build(MIX, 3, 1.0, VOCAB), sessions.build(MIX, 3, 2.0, VOCAB)
    n = len(a.sessions)
    assert len(b.sessions) >= 2 * n - 3
    assert np.allclose([s.start_s / 2 for s in a.sessions], [s.start_s for s in b.sessions[:n]])


def test_limits_hold():
    plan = sessions.build(MIX, 4, 1.5, VOCAB)
    lengths = plan.turn_lengths()
    assert max(p + a for p, a in lengths) <= MIX["max_context"]
    assert all(1 <= len(s.turns) <= MIX["turns"]["max"] for s in plan.sessions)
    for s in plan.sessions:
        for t in s.turns:
            assert MIX["message_tokens"]["min"] <= len(t.message) <= MIX["message_tokens"]["max"]
            assert MIX["answer_tokens"]["min"] <= t.answer_len <= MIX["answer_tokens"]["max"]
            assert t.message.min() >= 0 and t.message.max() < VOCAB
    first = [p for (p, _), in zip(lengths)][:1]
    assert first[0] == MIX["system_prompts"]["tokens"] + len(plan.sessions[0].turns[0].message)


def test_history_carries_prompts_and_answers():
    plan = sessions.build(MIX, 5, 1.0, VOCAB)
    s = next(s for s in plan.sessions if len(s.turns) >= 3)
    lengths = plan.turn_lengths()
    i = sum(len(x.turns) for x in plan.sessions[: plan.sessions.index(s)])
    (p0, a0), (p1, _) = lengths[i], lengths[i + 1]
    assert p1 == p0 + a0 + len(s.turns[1].message)
