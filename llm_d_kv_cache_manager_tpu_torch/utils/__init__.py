from .logging import DEBUG, TRACE, RateLimitedWarn, get_logger, log_context

__all__ = ["get_logger", "log_context", "RateLimitedWarn", "DEBUG", "TRACE"]
