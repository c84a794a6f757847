"""Output tokens the pod committed between the window's start and end,
over the window's length. Tokens are counted where the engine commits
them (the step that ends after them), so a request in flight at either
edge counts only its tokens inside."""

LAYER = "end to end"
UNIT = "tokens/s"
MOVES = None


def _committed_by(steps, t: float) -> int:
    done = [s.tokens for s in steps if s.t1 <= t]
    return done[-1] if done else 0


def read(run):
    n = _committed_by(run.steps, run.w1) - _committed_by(run.steps, run.w0)
    return n / (run.w1 - run.w0)
