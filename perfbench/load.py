"""Offers a traffic plan to the pod on its schedule.

A plan is sessions. A session starts at a fixed offset; each of its turns
is due ``think_s`` after the previous turn finished (closed within the
session), and sessions start on their own clock whatever the pod does
(open across sessions). With ``carry`` a turn's prompt is the previous
prompt, the tokens the pod served for it and the new message, so the pod
sees its own answers again as a chat history. Every request records when
it was due, when it was submitted, and the pod's finished ``Sequence``.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


@dataclass
class Turn:
    message: np.ndarray
    answer_len: int
    think_s: float


@dataclass
class Session:
    start_s: float
    prefix: Optional[int]  # index of the shared prompt the first turn opens with
    turns: list[Turn]


@dataclass
class Plan:
    sessions: list[Session]
    prefixes: list[np.ndarray]
    carry: bool

    def turn_lengths(self) -> list[tuple[int, int]]:
        """(prompt tokens, answer tokens) of every turn, assuming each
        answer runs to its length (greedy, no stop token)."""
        out = []
        for s in self.sessions:
            base = len(self.prefixes[s.prefix]) if s.prefix is not None else 0
            ctx = base
            for t in s.turns:
                ctx = (ctx if self.carry else base) + len(t.message)
                out.append((ctx, t.answer_len))
                ctx += t.answer_len
        return out


@dataclass
class Request:
    session: int
    turn: int
    due: float
    prompt: list[int]
    answer_len: int
    submit_t: Optional[float] = None
    seq: object = None
    error: Optional[str] = None
    finished: bool = False


@dataclass(order=True)
class _Due:
    due: float
    order: int
    session: int = field(compare=False)
    turn: int = field(compare=False)
    prompt: list = field(compare=False)


class LoadGenerator:
    """Runs ``plan`` from monotonic time ``t0``; submits nothing due at or
    after ``stop_at``. ``submit(prompt, answer_len)`` returns a Future of
    the finished sequence (the pod's ``submit``)."""

    def __init__(self, plan: Plan, submit: Callable, t0: float, stop_at: float,
                 clock: Callable[[], float] = time.monotonic):
        self.plan, self._submit, self.t0, self.stop_at = plan, submit, t0, stop_at
        self._clock = clock
        self._cv = threading.Condition()
        self._heap: list[_Due] = []
        self._order = itertools.count()
        self._outstanding = 0
        self._stop = False
        self.requests: list[Request] = []
        for i, s in enumerate(plan.sessions):
            prompt = self._prefix(s) + s.turns[0].message.tolist()
            self._push(t0 + s.start_s, i, 0, prompt)
        self._thread = threading.Thread(target=self._loop, name="perfbench-load", daemon=True)

    def _prefix(self, s: Session) -> list[int]:
        return self.plan.prefixes[s.prefix].tolist() if s.prefix is not None else []

    def _push(self, due: float, session: int, turn: int, prompt: list[int]) -> None:
        if due < self.stop_at:
            heapq.heappush(self._heap, _Due(due, next(self._order), session, turn, prompt))

    def start(self) -> None:
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stop:
                    now = self._clock()
                    if self._heap and self._heap[0].due <= now:
                        break
                    wait = self._heap[0].due - now if self._heap else 0.5
                    self._cv.wait(timeout=min(wait, 0.5))
                if self._stop:
                    return
                item = heapq.heappop(self._heap)
                self._outstanding += 1
            turn = self.plan.sessions[item.session].turns[item.turn]
            req = Request(item.session, item.turn, item.due, item.prompt, turn.answer_len)
            self.requests.append(req)
            req.submit_t = self._clock()
            try:
                fut = self._submit(item.prompt, turn.answer_len)
            except Exception as e:  # refused (admission, draining): a failed request
                self._done(req, None, f"{type(e).__name__}: {e}")
                continue
            fut.add_done_callback(lambda f, req=req: self._on_future(req, f))

    def _on_future(self, req: Request, fut) -> None:
        try:
            seq = fut.result()
        except Exception as e:  # the pod failed the request
            self._done(req, None, f"{type(e).__name__}: {e}")
            return
        self._done(req, seq, None)

    def _done(self, req: Request, seq, error: Optional[str]) -> None:
        req.seq, req.error = seq, error
        if seq is not None and getattr(seq, "finish_reason", None) is not None:
            req.error = f"finished early: {seq.finish_reason}"
        nxt = None
        if req.error is None:
            sess = self.plan.sessions[req.session]
            if req.turn + 1 < len(sess.turns):
                t = sess.turns[req.turn + 1]
                head = req.prompt + list(seq.generated_tokens) if self.plan.carry else self._prefix(sess)
                nxt = (seq.finish_time + sess.turns[req.turn].think_s, head + t.message.tolist())
        with self._cv:
            req.finished = True
            self._outstanding -= 1
            if nxt is not None:
                self._push(nxt[0], req.session, req.turn + 1, nxt[1])
            self._cv.notify_all()

    def wait_idle(self, deadline: float) -> bool:
        """Wait until nothing is in flight and nothing is left to submit
        before ``stop_at``, or until monotonic ``deadline``."""
        with self._cv:
            while self._outstanding or self._heap:
                left = deadline - self._clock()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(left, 0.5))
        return True

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10)

    def max_lag_s(self) -> float:
        lags = [r.submit_t - r.due for r in self.requests if r.submit_t is not None]
        return max(lags, default=0.0)
