"""Scheduler and block manager: prompt tokens served from the prefix cache
over all prompt tokens of the window's finished requests (those due
before the profiled slice), in percent."""

LAYER = "scheduler and block manager"
UNIT = "%"
MOVES = "ttft_p50_ms"


def read(run):
    done = [r.seq for r in run.layer_sample if not run.failed(r)]
    total = sum(s.user_prompt_len for s in done)
    if not total:
        return None
    return 100.0 * sum(min(s.num_cached_prompt, s.user_prompt_len) for s in done) / total
