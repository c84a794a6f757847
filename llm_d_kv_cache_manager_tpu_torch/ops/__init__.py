from .rmsnorm import rms_norm
from .rope import apply_rope, rope_frequencies
from .attention import prefill_with_paged_context
from .flash_prefill import flash_prefill_paged, flash_prefill_plain
from .paged_attention import paged_attention, paged_attention_reference
from .sampling import sample_tokens

__all__ = [
    "sample_tokens",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
    "prefill_with_paged_context",
    "flash_prefill_paged",
    "flash_prefill_plain",
    "paged_attention",
    "paged_attention_reference",
]
