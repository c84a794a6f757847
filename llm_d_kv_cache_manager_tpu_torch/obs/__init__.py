"""Observability. Only ``lifecycle`` (the block-lifecycle ledger and the
reuse-distance estimator, a copy of the JAX package's module) is here: the
metrics collector takes its bucket constants from it. Tracing, SLOs,
audit and federation are not ported."""
