from .rmsnorm import rms_norm
from .rope import apply_rope, rope_frequencies
from .attention import prefill_with_paged_context, widen_paged_context
from .flash_prefill import flash_prefill_paged, flash_prefill_plain
from .paged_attention import (
    paged_attention,
    paged_attention_reference,
    paged_attention_split_plain,
    paged_decode_int8,
    plan_decode_splits,
)
from .sampling import sample_tokens
# Last: gmm imports models.quant, whose package imports the names above.
from .gmm import (
    grouped_matmul,
    grouped_matmul_bf16,
    grouped_matmul_int8,
    grouped_matmul_plain,
    plan_grouped_matmul,
)

#: every kernel wrapper that counts its launches (``wrapper.launches``), by
#: kernel name
COUNTED = {
    "paged_decode": paged_attention,
    "paged_decode_int8": paged_decode_int8,
    "flash_prefill": flash_prefill_paged,
    "grouped_matmul_bf16": grouped_matmul_bf16,
    "grouped_matmul_int8": grouped_matmul_int8,
}

__all__ = [
    "COUNTED",
    "sample_tokens",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
    "prefill_with_paged_context",
    "widen_paged_context",
    "flash_prefill_paged",
    "flash_prefill_plain",
    "paged_attention",
    "paged_attention_reference",
    "paged_attention_split_plain",
    "plan_decode_splits",
    "paged_decode_int8",
    "grouped_matmul",
    "grouped_matmul_bf16",
    "grouped_matmul_int8",
    "grouped_matmul_plain",
    "plan_grouped_matmul",
]
