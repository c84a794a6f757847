"""Back-compat shim: sampling moved to ``ops.sampling`` so the model stack
can fuse it into device-side decode loops."""

from ..ops.sampling import sample_tokens

__all__ = ["sample_tokens"]
