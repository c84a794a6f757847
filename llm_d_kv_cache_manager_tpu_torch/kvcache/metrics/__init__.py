"""Process-wide counters and Prometheus metrics (a copy of the JAX
package's ``collector``; the transfer client bumps its breaker counters
here)."""

from . import collector  # noqa: F401
