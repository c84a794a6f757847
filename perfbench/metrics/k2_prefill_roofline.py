"""Kernels, K2 (``csrc/flash_prefill.cu``): the least time the profiled
slice's prefill attention calls need, over the device time of K2's kernel
in the slice, in percent. A call is one layer of one prefill; its work is
each row's chunk attending causally over its cached context and itself,
each query over at most the layer's span of keys: QK^T and PV FLOPs, and
the chunk's q, k, v and output plus the cached K and V its first query
sees, read and written once (a cached token an earlier row of the batch
holds too counts once). Summed over the model's layers, each with its own
span."""

from typing import Optional

from perfbench.readers import roofline_pct
from perfbench.work import attn_flops, bound_s

LAYER = "kernels"
UNIT = "%"
MOVES = "ttft_p95_ms"
KERNELS = ("flash_prefill_kernel",)


def work(m, rows: list[tuple[int, int]], ctx_tokens: list[int],
         span: Optional[int] = None) -> tuple[float, float]:
    """(bytes, FLOPs) of one call with attention span ``span`` over rows
    of (chunk, context) whose cached tokens in reach hold ``ctx_tokens``
    tokens not held by an earlier row."""
    b = m.dtype_bytes
    fresh = sum(chunk for chunk, _ in rows) * (2 * m.heads + 2 * m.kv_heads) * m.hd * b
    cached = sum(ctx_tokens) * 2 * m.kv_heads * m.hd * b
    return fresh + cached, sum(attn_flops(m, chunk, ctx, span) for chunk, ctx in rows)


def read(run):
    bound = sum(n * bound_s(*work(run.m, s.rows, s.row_ctx_tokens[span], span))
                for s in run.slice_steps if s.rows for span, n in run.m.spans.items())
    return roofline_pct(run, KERNELS, bound)
