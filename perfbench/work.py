"""The work a step's inputs need, counted from shapes, and the card's peaks.

Peaks are NVIDIA's published figures for one H100 SXM (dense bf16, HBM3);
``bound_s`` is the least time the card could take, the larger of the
operations over the compute peak and the bytes over the memory peak (the
arithmetic of ``chip_smoke.bound_ms``). Work is what the inputs need:
each lane's context, each prefill row's chunk and context, the model's
active parameters, summed over the model's layers, each with its own
attention span and FFN (``model.Dims``). It does not count what a kernel
happens to do (padding, re-reads), so a kernel that replaces another is
counted the same.
"""

from __future__ import annotations

from typing import Optional

from .model import Dims, Ffn

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12


def bound_s(n_bytes: float, flops: float) -> float:
    return max(n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS)


def ffn_active_params(m: Dims, ffn: Ffn) -> int:
    """FFN parameters one token multiplies by in one layer: the router,
    ``top_k`` experts and any shared expert of a routed FFN, or the whole
    dense FFN."""
    if ffn.experts:
        return m.d * ffn.experts + (ffn.top_k * ffn.width + ffn.shared) * 3 * m.d
    return 3 * m.d * ffn.width


def body_params(m: Dims) -> int:
    """Active parameters a token passes through below the head."""
    return sum(n * (layer.attn_params + ffn_active_params(m, layer.ffn))
               for layer, n in m.kinds.items())


def attended_keys(queries: int, ctx_before: int, span: Optional[int] = None) -> float:
    """Keys that ``queries`` consecutive tokens after ``ctx_before``
    earlier ones see, each itself and at most ``span`` keys in all (None:
    the whole context): the sum over i = 1..queries of
    min(ctx_before + i, span)."""
    last = ctx_before + queries
    if span is None or last <= span:
        return queries * ctx_before + queries * (queries + 1) / 2
    first = ctx_before + 1
    if first >= span:
        return queries * span
    # first..span grow one key a query; the rest see span each
    return (first + span) * (span - first + 1) / 2 + (last - span) * span


def attn_flops(m: Dims, queries: int, ctx_before: int, span: Optional[int] = None) -> float:
    """QK^T and PV of ``queries`` consecutive tokens over ``ctx_before``
    earlier tokens plus themselves (causal, within ``span``), one layer,
    all heads."""
    return 4.0 * m.heads * m.hd * attended_keys(queries, ctx_before, span)


def decode_flops(m: Dims, ctx: int) -> float:
    """One lane's model step at context ``ctx`` (the current token
    included): the body, attention over the context and the head."""
    return 2.0 * (body_params(m) + m.d * m.vocab) + sum(
        n * attn_flops(m, 1, ctx - 1, span) for span, n in m.spans.items())


def prefill_flops(m: Dims, chunk: int, ctx: int) -> float:
    """One prefill row: ``chunk`` new tokens over ``ctx`` cached ones; the
    head runs for the sampled (last) position only."""
    return (2.0 * body_params(m) * chunk + 2.0 * m.d * m.vocab
            + sum(n * attn_flops(m, chunk, ctx, span) for span, n in m.spans.items()))
