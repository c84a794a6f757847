"""Fleet-controller helpers the scoring service needs: ``mrc``, the
per-pod to fleet miss-ratio-curve aggregation behind the scorer's
``/debug/mrc``."""

from .mrc import aggregate_mrc, hit_rate_at

__all__ = ["aggregate_mrc", "hit_rate_at"]
