from .rmsnorm import rms_norm
from .rope import apply_rope, rope_frequencies
from .attention import causal_prefill_attention, prefill_with_paged_context, widen_paged_context
from .flash_prefill import flash_prefill_paged, flash_prefill_plain
from .paged_attention import (
    paged_attention,
    paged_attention_reference,
    paged_attention_split_plain,
    paged_decode_int8,
    plan_decode_splits,
)
from .sampling import sample_tokens, spec_sample
from ._counting import LAUNCH_LOCK
# Last: gmm imports models.quant, whose package imports the names above.
from .gmm import (
    GroupedMatmul,
    grouped_matmul,
    grouped_matmul_bf16,
    grouped_matmul_bf16_t,
    grouped_matmul_int8,
    grouped_matmul_plain,
    grouped_matmul_tgmm,
    grouped_matmul_tgmm_plain,
    plan_grouped_matmul,
    plan_grouped_matmul_tgmm,
)

#: every kernel wrapper that counts its launches (``wrapper.launches``, each
#: change under ``LAUNCH_LOCK``), by kernel name
COUNTED = {
    "paged_decode": paged_attention,
    "paged_decode_int8": paged_decode_int8,
    "flash_prefill": flash_prefill_paged,
    "grouped_matmul_bf16": grouped_matmul_bf16,
    "grouped_matmul_int8": grouped_matmul_int8,
    "grouped_matmul_bf16_t": grouped_matmul_bf16_t,
    "grouped_matmul_tgmm": grouped_matmul_tgmm,
}

__all__ = [
    "COUNTED",
    "LAUNCH_LOCK",
    "sample_tokens",
    "spec_sample",
    "rms_norm",
    "apply_rope",
    "rope_frequencies",
    "causal_prefill_attention",
    "prefill_with_paged_context",
    "widen_paged_context",
    "flash_prefill_paged",
    "flash_prefill_plain",
    "paged_attention",
    "paged_attention_reference",
    "paged_attention_split_plain",
    "plan_decode_splits",
    "paged_decode_int8",
    "GroupedMatmul",
    "grouped_matmul",
    "grouped_matmul_bf16",
    "grouped_matmul_bf16_t",
    "grouped_matmul_int8",
    "grouped_matmul_plain",
    "grouped_matmul_tgmm",
    "grouped_matmul_tgmm_plain",
    "plan_grouped_matmul",
    "plan_grouped_matmul_tgmm",
]
