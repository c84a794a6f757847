"""Observability: the block-lifecycle ledger and reuse-distance estimator
(``lifecycle``), request tracing with W3C ``traceparent`` propagation
(``tracing``), the scorer's routing-quality audit and index-staleness
probes (``audit``) and fleet federation (``federation``), copies of the
JAX package's modules. SLOs and the flight recorder are not ported."""
